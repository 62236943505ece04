"""Batched semi-global alignment with ungapped-block tracking, on the device.

Device replacement for the scikit-bio `global_pairwise_align_nucleotide` +
`extract_homology` inner loop of the reference's microhomology and mechanism
analyses (microhomology.py:380-389 `get_micro_homo`,
microhomology.py:445-474 `extract_homology`, mechanism.py:239-255): the
statistic is the length of the **longest ungapped block** (consecutive
aligned columns, match or mismatch) on an optimal alignment of the two
100-bp junction flanks, with free terminal gaps (skbio's
`penalize_terminal_gaps=False` default) and blastn-like scoring
(match 2, mismatch -3, gap open 5, extend 2).

Formulation (same machinery as ops/sw.py): lax.scan over query rows; the
horizontal-gap term is an associative prefix max, the vertical-gap term a
running max across rows. Instead of an origin register, every max decision
propagates a pair of registers (current diagonal run length R, best run M);
a diagonal move does R+1 / max(M, R+1), any gap move resets R to 0 and
carries M unchanged — so one forward pass yields the block statistic with no
traceback. Tie order everywhere: diagonal > vertical gap > horizontal gap,
latest gap-open preferred — mirrored exactly by the numpy oracle below.
O(L) elementwise work per row, batch vmapped by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.int32(-(1 << 28))


def _pick(take_b, a, b):
    return tuple(jnp.where(take_b, y, x) for x, y in zip(a, b))


def _maxtri(a, b):
    """max on (value, run, maxrun) triples; ties keep `a`."""
    return _pick(b[0] > a[0], a, b)


def _maxtri_late(a, b):
    """max preferring the later element `b` on ties (for prefix scans whose
    oracle recurrence keeps the latest gap-open)."""
    return _pick(b[0] >= a[0], a, b)


@partial(jax.jit, static_argnames=("match", "mismatch", "gap_open", "gap_ext"))
def nw_max_ungapped(query, ref, match=2, mismatch=-3, gap_open=-5,
                    gap_ext=-2):
    """Semi-global alignment score + longest ungapped block.

    Args:
        query: uint8 [B, M] base codes (0..3; 4 = N — aligns as mismatch).
        ref:   uint8 [B, N] base codes.

    Returns:
        (score int32 [B], max_run int32 [B]): optimal score with free
        terminal gaps, and the longest run of aligned columns on the optimal
        path picked by the tie order above.

    A length-g gap costs gap_open + g*gap_ext (both arguments negative).
    """
    B, M = query.shape
    N = ref.shape[1]
    e = jnp.int32(gap_ext)
    o = jnp.int32(gap_open)
    jpos = jnp.arange(N + 1, dtype=jnp.int32)
    Z1 = jnp.zeros((B, 1), jnp.int32)

    def row_step(carry, q):
        Hp, Rp, Mp, Fv, Fr, Fm = carry
        sub = jnp.where(
            (ref == q[:, None]) & (q[:, None] < 4) & (ref < 4),
            jnp.int32(match), jnp.int32(mismatch),
        )  # [B, N]
        # vertical gap (consumes a query base); tie prefers fresh open
        F_open = (Hp + o + e, jnp.zeros_like(Rp), Mp)
        F_ext = (Fv + e, Fr, Fm)
        Fv, Fr, Fm = _maxtri(F_open, F_ext)
        # diagonal into column j+1 comes from previous row column j
        diag_v = Hp[:, :-1] + sub
        diag_r = Rp[:, :-1] + 1
        diag = (diag_v, diag_r, jnp.maximum(Mp[:, :-1], diag_r))
        # pre-horizontal candidate; tie prefers diagonal
        cand = _maxtri(diag, (Fv[:, 1:], Fr[:, 1:], Fm[:, 1:]))
        # column 0 = pure leading query terminal gap: free (semi-global)
        base_v = jnp.concatenate([Z1, cand[0]], 1)
        base_r = jnp.concatenate([Z1, cand[1]], 1)
        base_m = jnp.concatenate([Z1, cand[2]], 1)
        # horizontal gap: E[j] = max_{j'<j} base[j'] + o + (j-j')*e,
        # tie preferring the latest j' (latest open)
        A = (base_v + o - jpos[None, :] * e, jnp.zeros_like(base_r), base_m)
        P = jax.lax.associative_scan(_maxtri_late, A, axis=1)
        E_v = jnp.concatenate(
            [jnp.full((B, 1), NEG), P[0][:, :-1] + jpos[None, 1:] * e], 1
        )
        E = (E_v, jnp.zeros_like(base_r),
             jnp.concatenate([Z1, P[2][:, :-1]], 1))
        H = _maxtri((base_v, base_r, base_m), E)
        return (H[0], H[1], H[2], Fv, Fr, Fm), (H[0][:, -1], H[2][:, -1])

    # row 0: free leading ref terminal gap => zeros
    H0 = jnp.zeros((B, N + 1), jnp.int32)
    Z = jnp.zeros((B, N + 1), jnp.int32)
    F0 = jnp.full((B, N + 1), NEG)
    (Hl, _, Ml, _, _, _), (col_v, col_m) = jax.lax.scan(
        row_step, (H0, Z, Z, F0, Z, Z), jnp.swapaxes(query, 0, 1)
    )
    zero = jnp.zeros((B,), jnp.int32)
    # free trailing gaps: best over last column (earliest row on tie, then
    # the empty alignment) then last row (earliest column on tie)
    ci = jnp.argmax(col_v, 0)
    last_col = _maxtri(
        (jnp.max(col_v, 0), zero,
         jnp.take_along_axis(col_m, ci[None], 0)[0]),
        (zero, zero, zero),
    )
    ri = jnp.argmax(Hl, 1)
    last_row = (
        jnp.max(Hl, 1), zero,
        jnp.take_along_axis(Ml, ri[:, None], 1)[:, 0],
    )
    best = _maxtri(last_col, last_row)
    return best[0], best[2]


def nw_max_ungapped_np(query, ref, match=2, mismatch=-3, gap_open=-5,
                       gap_ext=-2):
    """Plain-numpy oracle (per pair, full DP) with the identical tie order,
    for tests."""
    outs_s, outs_m = [], []
    NEGV = -(1 << 28)
    for q, r in zip(np.asarray(query), np.asarray(ref)):
        M, N = len(q), len(r)
        H = np.zeros((M + 1, N + 1), np.int64)
        E = np.full((M + 1, N + 1), NEGV, np.int64)
        F = np.full((M + 1, N + 1), NEGV, np.int64)
        R = np.zeros((M + 1, N + 1), np.int64)
        Mx = np.zeros((M + 1, N + 1), np.int64)
        FR = np.zeros_like(R)
        FM = np.zeros_like(R)
        ER = np.zeros_like(R)
        EM = np.zeros_like(R)
        for i in range(1, M + 1):
            for j in range(0, N + 1):
                # vertical gap state (tie prefers fresh open)
                fo = H[i - 1, j] + gap_open + gap_ext
                fe = F[i - 1, j] + gap_ext
                if fe > fo:
                    F[i, j], FR[i, j], FM[i, j] = fe, FR[i-1, j], FM[i-1, j]
                else:
                    F[i, j], FR[i, j], FM[i, j] = fo, 0, Mx[i - 1, j]
                if j == 0:
                    H[i, 0], R[i, 0], Mx[i, 0] = 0, 0, 0
                    continue
                # horizontal gap state (tie prefers fresh open = latest j')
                eo = H[i, j - 1] + gap_open + gap_ext
                ee = E[i, j - 1] + gap_ext
                if ee > eo:
                    E[i, j], ER[i, j], EM[i, j] = ee, ER[i, j-1], EM[i, j-1]
                else:
                    E[i, j], ER[i, j], EM[i, j] = eo, 0, Mx[i, j - 1]
                s = match if (q[i - 1] == r[j - 1] and q[i - 1] < 4
                              and r[j - 1] < 4) else mismatch
                dv = H[i - 1, j - 1] + s
                dr = R[i - 1, j - 1] + 1
                dm = max(Mx[i - 1, j - 1], dr)
                best, br, bm = dv, dr, dm  # tie order: diag > F > E
                if F[i, j] > best:
                    best, br, bm = F[i, j], FR[i, j], FM[i, j]
                if E[i, j] > best:
                    best, br, bm = E[i, j], ER[i, j], EM[i, j]
                H[i, j], R[i, j], Mx[i, j] = best, br, bm
        # free trailing gaps, same candidate order as the device kernel
        col = (NEGV, 0)
        for i in range(1, M + 1):
            if H[i, N] > col[0]:
                col = (H[i, N], Mx[i, N])
        if 0 > col[0]:
            col = (0, 0)
        row = (NEGV, 0)
        for j in range(0, N + 1):
            if H[M, j] > row[0]:
                row = (H[M, j], Mx[M, j])
        best = col if col[0] >= row[0] else row
        outs_s.append(best[0])
        outs_m.append(best[1])
    return np.array(outs_s), np.array(outs_m)
