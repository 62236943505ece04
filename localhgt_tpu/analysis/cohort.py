"""Cohort-scale drivers: LODO cross-cohort validation, KEGG pathway
enrichment, and time-series HGT fingerprinting.

Reusable cores of the reference's cohort-specific studies:

* LODO (leave-one-dataset-out): markers selected on the training cohorts,
  a classifier trained on all-but-one cohort and scored on the held-out
  one; per-cohort AUC + the sample-weighted mean
  (paper_results/CRC_LODO_Analysis_v2.py:700-724 `LODO`).
* KEGG enrichment: per-pathway Fisher exact test of an input KO list vs a
  background KO list, Benjamini-Hochberg corrected
  (paper_results/kegg_enrichment.py:47-80 `enrichment_analysis`). The
  reference fetches pathway names from the KEGG REST API; here the caller
  supplies the ko -> pathways mapping (no network access assumed).
* Time-line fingerprinting: whether per-sample HGT profiles identify the
  individual in a longitudinal cohort — Spearman correlation of profile
  vectors (or the event-sharing Jaccard ratio) for same-individual vs
  different-individual sample pairs, Mann-Whitney U tested
  (paper_results/ana_time_lines.py:185-236 `get_pearson`,
  :593-608 `get_jaccard_dist`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from localhgt_tpu.analysis import classifier


def benjamini_hochberg(pvals) -> np.ndarray:
    """BH step-up adjusted p-values (multipletests(method='fdr_bh')
    equivalent, kegg_enrichment.py:75)."""
    p = np.asarray(pvals, float)
    n = len(p)
    if n == 0:
        return p
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    # enforce monotonicity from the largest p down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n, float)
    out[order] = np.minimum(ranked, 1.0)
    return out


def lodo(samples, group1: str, group2: str,
         marker_num: int = classifier.DEFAULT_MARKERS,
         model: str = "logreg", seed: int = 42) -> dict:
    """Leave-one-dataset-out evaluation over the samples' `cohort` labels
    (CRC_LODO_Analysis_v2.py:700-724).

    For each cohort: markers are selected on the remaining cohorts only,
    a model trains on them and is scored on the held-out cohort. Returns
    {"per_cohort": {name: auc}, "weighted_mean": float, "n_markers": {...}}
    with the mean weighted by held-out sample count, as the reference
    reports (auc_total += roc_auc * len(test_label))."""
    elig = [s for s in samples
            if s.disease in (group1, group2)
            or group1 in s.full_disease or group2 in s.full_disease]
    cohorts = sorted({s.cohort for s in elig})
    if len(cohorts) < 2:
        raise ValueError(
            f"LODO needs >= 2 cohorts; got {cohorts!r} — set the cohort "
            "column in the phenotype CSV")
    per = {}
    nmk = {}
    total = 0.0
    n_total = 0
    for held in cohorts:
        train_s = [s for s in elig if s.cohort != held]
        test_s = [s for s in elig if s.cohort == held]
        markers = classifier.select_markers(train_s, group1, group2,
                                            marker_num)
        nmk[held] = len(markers)
        if not markers or not test_s:
            per[held] = float("nan")
            continue
        Xt, yt, _ = classifier.feature_matrix(train_s, markers, group1,
                                              group2)
        Xv, yv, _ = classifier.feature_matrix(test_s, markers, group1,
                                              group2)
        Xt, yt = classifier.undersample(Xt, yt, seed)
        if model == "rf":
            from sklearn.ensemble import RandomForestClassifier

            clf = RandomForestClassifier(n_estimators=100, random_state=seed)
            clf.fit(Xt, yt)
            scores = clf.predict_proba(Xv)[:, 1]
        else:
            score, _ = classifier.train_logreg(Xt, yt, seed=seed)
            scores = score(Xv)
        auc = classifier.roc_auc(yv, scores)
        per[held] = auc
        if auc == auc:  # not NaN
            total += auc * len(yv)
            n_total += len(yv)
    return {
        "per_cohort": per,
        "weighted_mean": (total / n_total) if n_total else float("nan"),
        "n_markers": nmk,
    }


def kegg_enrichment(input_kos, background_kos, ko_pathway: dict,
                    skip_prefix: str = "ko") -> list[dict]:
    """Per-pathway Fisher exact enrichment of `input_kos` against
    `background_kos` (kegg_enrichment.py:20-80): contingency
    [[in-path input, rest input], [in-path background, rest background]],
    BH-corrected. `ko_pathway` maps KO id -> iterable of pathway ids;
    pathways whose id starts with `skip_prefix` are skipped (the reference
    drops 'ko'-prefixed duplicates of 'map' pathways). Returns rows sorted
    by adjusted p."""
    from scipy.stats import fisher_exact

    input_kos = list(input_kos)
    background_kos = list(background_kos)

    def counts(kos):
        c = defaultdict(int)
        for ko in kos:
            for pid in ko_pathway.get(ko, ()):
                c[pid] += 1
        return c

    ic = counts(input_kos)
    bc = counts(background_kos)
    rows = []
    for pid in sorted(set(ic) | set(bc)):
        if skip_prefix and pid.startswith(skip_prefix):
            continue
        a = ic[pid]
        b = len(input_kos) - a
        c = bc[pid]
        d = len(background_kos) - c
        odds, p = fisher_exact([[a, b], [c, d]])
        rows.append({"pathway": pid, "input_n": a, "background_n": c,
                     "odds_ratio": odds, "p": p})
    padj = benjamini_hochberg([r["p"] for r in rows])
    for r, q in zip(rows, padj):
        r["p_adj"] = float(q)
    rows.sort(key=lambda r: r["p_adj"])
    return rows


def profile_vectors(samples) -> tuple[dict, list]:
    """Per-sample binary HGT-presence vectors over the union of hgt_tags
    (ana_time_lines.py:165-183 get_HGT_table). Returns
    (sample_id -> float vector, tag list)."""
    tags = sorted({b.hgt_tag for s in samples for b in s.bkps})
    index = {t: i for i, t in enumerate(tags)}
    out = {}
    for s in samples:
        v = np.zeros(len(tags), np.float32)
        for b in s.bkps:
            v[index[b.hgt_tag]] = 1.0
        out[s.sample_id] = v
    return out, tags


def _spearman(a, b) -> float:
    from scipy.stats import rankdata

    ra, rb = rankdata(a), rankdata(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    d = float(np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))
    return float((ra * rb).sum() / d) if d else float("nan")


def timeline_fingerprint(vectors: dict, individual_of: dict) -> dict:
    """Same-individual vs different-individual similarity of HGT profiles
    (ana_time_lines.py:185-236 get_pearson): Spearman correlation per
    sample pair, Mann-Whitney U between the two groups.

    Args:
        vectors: sample_id -> profile vector (profile_vectors()).
        individual_of: sample_id -> individual id.
    """
    from scipy.stats import mannwhitneyu

    ids = sorted(vectors)
    same, diff = [], []
    for i in range(len(ids)):
        for j in range(i + 1, len(ids)):
            r = _spearman(vectors[ids[i]], vectors[ids[j]])
            if r != r:
                continue
            if individual_of.get(ids[i]) == individual_of.get(ids[j]):
                same.append(r)
            else:
                diff.append(r)
    p = float("nan")
    if same and diff:
        _, p = mannwhitneyu(same, diff)
    return {
        "n_same": len(same), "n_diff": len(diff), "p": float(p),
        "mean_same": float(np.mean(same)) if same else float("nan"),
        "mean_diff": float(np.mean(diff)) if diff else float("nan"),
        "median_same": float(np.median(same)) if same else float("nan"),
        "median_diff": float(np.median(diff)) if diff else float("nan"),
    }


def jaccard_share(events1, events2, max_diff: int = 50) -> float:
    """Event-sharing ratio between two samples' event lists
    (ana_time_lines.py:593-608 get_jaccard_dist): events match when both
    genomes, all three coordinates (within max_diff) and the reverse flag
    agree. Events are (ins_genome, ins_pos, del_genome, del_start,
    del_end, reverse_flag) tuples."""
    share = 0
    total = len(events1)
    for e2 in events2:
        hit = any(
            e1[0] == e2[0] and e1[2] == e2[2]
            and abs(e1[1] - e2[1]) < max_diff
            and abs(e1[3] - e2[3]) < max_diff
            and abs(e1[4] - e2[4]) < max_diff
            and e1[5] == e2[5]
            for e1 in events1
        )
        if hit:
            share += 1
        else:
            total += 1
    return share / total if total else 0.0
