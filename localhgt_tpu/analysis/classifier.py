"""Differential-HGT markers + phenotype classification
(HGT_classifier.py:247-458 `Marker`).

Pipeline: (1) per junction tag, count carrier samples in each phenotype
group; (2) Fisher exact test per tag with Bonferroni correction, keep
adj-p < 0.05, take the top `marker_num` as markers
(HGT_classifier.py:294-332 `select_diff_HGT`); (3) build binary
sample x marker presence matrices, balance the training split by random
undersampling (HGT_classifier.py:334-366), train, report validation AUC
(HGT_classifier.py:368-380).

The reference trains a scikit-learn RandomForest on host. Here the default
model is an L2 logistic regression trained **on device** with jax/optax
(full-batch Adam — the matrices are tiny, so one jit'd `lax.scan` over steps
is a single dispatch); `model="rf"` selects the reference's RandomForest for
head-to-head parity.
"""

from __future__ import annotations

import numpy as np

MARKER_ALPHA = 0.05
DEFAULT_MARKERS = 20


def bonferroni(pvals) -> np.ndarray:
    p = np.asarray(pvals, float)
    return np.minimum(p * len(p), 1.0)


def carrier_counts(samples, group1: str, group2: str):
    """tag -> [n_carriers_g1, n_carriers_g2] plus group sizes; a sample
    carries a tag if any retained bkp has that hgt_tag
    (HGT_classifier.py:259-292 `extract_HGT`)."""
    counts: dict = {}
    n = [0, 0]
    for s in samples:
        if s.disease == group1 or group1 in s.full_disease:
            gi = 0
        elif s.disease == group2 or group2 in s.full_disease:
            gi = 1
        else:
            continue
        n[gi] += 1
        for tag in {b.hgt_tag for b in s.bkps}:
            counts.setdefault(tag, [0, 0])[gi] += 1
    return counts, n


def select_markers(samples, group1: str, group2: str,
                   marker_num: int = DEFAULT_MARKERS):
    """Fisher-exact + Bonferroni marker selection
    (HGT_classifier.py:294-332). Returns {tag: column_index}."""
    from scipy.stats import fisher_exact

    counts, (n1, n2) = carrier_counts(samples, group1, group2)
    tags, pvals = [], []
    for tag, (a, c) in counts.items():
        b, d = n1 - a, n2 - c
        _, p = fisher_exact([[a, b], [c, d]])
        tags.append(tag)
        pvals.append(p)
    if not tags:
        return {}
    padj = bonferroni(pvals)
    keep = [(p, t) for p, t in zip(padj, tags) if p < MARKER_ALPHA]
    keep.sort()
    return {t: i for i, (_, t) in enumerate(keep[:marker_num])}


def feature_matrix(samples, markers: dict, group1: str, group2: str):
    """Binary presence matrix X [n, m] and labels y (group1=0, group2=1)
    (HGT_classifier.py:334-357)."""
    X, y, ids = [], [], []
    for s in samples:
        if s.disease == group1 or group1 in s.full_disease:
            lab = 0
        elif s.disease == group2 or group2 in s.full_disease:
            lab = 1
        else:
            continue
        row = np.zeros(len(markers), np.float32)
        for b in s.bkps:
            j = markers.get(b.hgt_tag)
            if j is not None:
                row[j] = 1.0
        X.append(row)
        y.append(lab)
        ids.append(s.sample_id)
    return (np.stack(X) if X else np.zeros((0, len(markers)), np.float32),
            np.asarray(y, np.int32), ids)


def undersample(X, y, seed: int = 42):
    """Random undersampling of the majority class
    (HGT_classifier.py:364-366 `RandomUnderSampler(random_state=42)`)."""
    rng = np.random.default_rng(seed)
    idx0 = np.flatnonzero(y == 0)
    idx1 = np.flatnonzero(y == 1)
    m = min(len(idx0), len(idx1))
    pick = np.concatenate([
        rng.choice(idx0, m, replace=False), rng.choice(idx1, m, replace=False)
    ])
    pick.sort()
    return X[pick], y[pick]


def roc_auc(y_true, scores) -> float:
    """Rank-based AUC (equivalent to sklearn.roc_auc_score)."""
    from scipy.stats import rankdata

    y = np.asarray(y_true)
    s = np.asarray(scores, float)
    n1 = int((y == 1).sum())
    n0 = int((y == 0).sum())
    if n1 == 0 or n0 == 0:
        return float("nan")
    r = rankdata(s)
    return float((r[y == 1].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def train_logreg(X, y, l2: float = 1e-3, steps: int = 500,
                     lr: float = 0.05, seed: int = 0):
    """L2 logistic regression trained on device; returns a scoring closure.

    One jit'd lax.scan over full-batch Adam steps — a single device dispatch
    for the whole fit (the marker matrices are tens x tens)."""
    import jax
    import jax.numpy as jnp
    import optax

    Xj = jnp.asarray(X, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)
    d = X.shape[1]
    params = {
        "w": jnp.zeros((d,), jnp.float32),
        "b": jnp.zeros((), jnp.float32),
    }
    opt = optax.adam(lr)

    def loss_fn(p):
        logits = Xj @ p["w"] + p["b"]
        ll = optax.sigmoid_binary_cross_entropy(logits, yj).mean()
        return ll + l2 * jnp.sum(p["w"] ** 2)

    @jax.jit
    def fit(p):
        st = opt.init(p)

        def step(carry, _):
            p, st = carry
            g = jax.grad(loss_fn)(p)
            up, st = opt.update(g, st)
            return (optax.apply_updates(p, up), st), ()

        (p, _), _ = jax.lax.scan(step, (p, st), None, length=steps)
        return p

    params = jax.device_get(fit(params))

    def score(Xv):
        z = np.asarray(Xv, np.float32) @ params["w"] + params["b"]
        return 1.0 / (1.0 + np.exp(-z))

    return score, params


def train_and_eval(samples, group1: str, group2: str,
                   marker_num: int = DEFAULT_MARKERS, val_frac: float = 0.2,
                   model: str = "logreg", seed: int = 42) -> dict:
    """End-to-end marker selection + training + validation AUC
    (HGT_classifier.py:334-380 `training`). Markers are selected on the
    training split only."""
    rng = np.random.default_rng(seed)
    elig = [s for s in samples
            if s.disease in (group1, group2)
            or group1 in s.full_disease or group2 in s.full_disease]
    order = rng.permutation(len(elig))
    n_val = max(1, int(len(elig) * val_frac))
    val_ids = {elig[i].sample_id for i in order[:n_val]}
    train_s = [s for s in elig if s.sample_id not in val_ids]
    val_s = [s for s in elig if s.sample_id in val_ids]

    markers = select_markers(train_s, group1, group2, marker_num)
    if not markers:
        return {"auc": float("nan"), "n_markers": 0,
                "n_train": len(train_s), "n_val": len(val_s)}
    Xt, yt, _ = feature_matrix(train_s, markers, group1, group2)
    Xv, yv, _ = feature_matrix(val_s, markers, group1, group2)
    Xt, yt = undersample(Xt, yt, seed)

    if model == "rf":
        from sklearn.ensemble import RandomForestClassifier

        rfc = RandomForestClassifier(n_estimators=100, random_state=seed)
        rfc.fit(Xt, yt)
        scores = rfc.predict_proba(Xv)[:, 1]
    else:
        score, _ = train_logreg(Xt, yt, seed=seed)
        scores = score(Xv)
    return {"auc": roc_auc(yv, scores), "n_markers": len(markers),
            "n_train": len(Xt), "n_val": len(Xv), "markers": markers}
