"""Batched affine-gap local alignment (Smith-Waterman) on the device.

Replaces two external/CPU components of the reference pipeline:
  * `bwa mem` read alignment against the extracted sub-reference
    (pipeline.sh:48) — used by localhgt_tpu.pipeline.align as the extension
    kernel of seed-and-extend;
  * scikit-bio's StripedSmithWaterman scoring in the precise-breakpoint scan
    (accurate_bkp.py:29-37,398-496) — used batched by
    localhgt_tpu.pipeline.accbkp.

Formulation: lax.scan over query rows; within a row the gap-in-query term E is
an associative prefix max (a length-log(N) scan), and the
gap-in-ref term F is a running max carried across rows — both derived from the
identity  max_g(H[x-g] + open + g*ext) = runmax(H[x'] - x'*ext) + open + x*ext.
E/F chains through other gaps are never optimal (open <= ext <= 0), so this is
the exact SW recurrence with no sequential inner loop.

Alignment *start* coordinates are recovered without traceback by propagating a
packed origin register through every max decision (including through the
prefix scans), so one forward pass yields score, query span and ref span.
All shapes static; batch B is vmapped; scores int32.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG = jnp.int32(-(1 << 28))


def _maxpair(a, b):
    """max on (value, origin) pairs; ties keep `a` (earlier origin)."""
    av, ao = a
    bv, bo = b
    take_b = bv > av
    return jnp.where(take_b, bv, av), jnp.where(take_b, bo, ao)


@partial(jax.jit, static_argnames=("match", "mismatch", "gap_open", "gap_ext"))
def sw_align(query, ref, match=1, mismatch=-4, gap_open=-6, gap_ext=-1):
    """Batched local alignment with full span recovery.

    Args:
        query: uint8 [B, M] base codes (4 = N/pad; never matches).
        ref:   uint8 [B, N] base codes (4 = N/pad).

    Returns dict of int32 [B]:
        score, qstart, qend, rstart, rend  (ends inclusive; a zero-score
        alignment reports qstart=qend=rstart=rend=0).

    Gap cost of length g is gap_open + g*gap_ext (bwa-mem convention: a 1-base
    gap costs open+ext).
    """
    B, M = query.shape
    N = ref.shape[1]
    o = jnp.int32(gap_open)
    e = jnp.int32(gap_ext)
    jpos = jnp.arange(N, dtype=jnp.int32)

    def pack(i, j):
        return i * jnp.int32(N + 1) + j

    def row_step(carry, qi):
        H_prev, O_prev, Mf, MfO, i = carry
        q, = qi
        sub = jnp.where(
            (ref == q[:, None]) & (ref < 4) & (q[:, None] < 4),
            jnp.int32(match), jnp.int32(mismatch),
        )
        # diagonal: H_prev shifted right by one along j
        Hd = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), H_prev[:, :-1]], 1)
        Od = jnp.concatenate(
            [pack(i, jnp.zeros((B, 1), jnp.int32)), O_prev[:, :-1]], 1
        )
        # fresh start origin at (i, j): alignment begins consuming (i, j)
        start_O = pack(i, jpos)[None, :] * jnp.ones((B, 1), jnp.int32)
        diag = Hd + sub
        diagO = jnp.where(Hd > 0, Od, start_O)
        # F: gap in ref (vertical), from running max across previous rows
        F = Mf + o + i * e
        H0 = jnp.maximum(diag, 0)
        O0 = diagO
        H1, O1 = _maxpair((H0, O0), (F, MfO))
        # E: gap in query (horizontal) via prefix max of H1 - j*ext
        T = H1 - jpos[None, :] * e
        Tm, TmO = jax.lax.associative_scan(_maxpair, (T, O1), axis=1)
        # shift by one: E[j] uses j' < j
        Tm = jnp.concatenate([jnp.full((B, 1), NEG), Tm[:, :-1]], 1)
        TmO = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), TmO[:, :-1]], 1)
        E = Tm + o + jpos[None, :] * e
        H, O = _maxpair((H1, O1), (E, TmO))
        H = jnp.maximum(H, 0)
        newMf, newMfO = _maxpair((Mf, MfO), (H - i * e, O))
        return (H, O, newMf, newMfO, i + 1), (H, O)

    H0 = jnp.zeros((B, N), jnp.int32)
    O0 = jnp.zeros((B, N), jnp.int32)
    Mf0 = jnp.full((B, N), NEG)
    (_, _, _, _, _), (Hs, Os) = jax.lax.scan(
        row_step, (H0, O0, Mf0, O0, jnp.int32(0)), (query.T,)
    )
    # Hs: [M, B, N]
    flat = Hs.transpose(1, 0, 2).reshape(B, M * N)
    flatO = Os.transpose(1, 0, 2).reshape(B, M * N)
    best = jnp.argmax(flat, axis=1)
    score = jnp.take_along_axis(flat, best[:, None], 1)[:, 0]
    origin = jnp.take_along_axis(flatO, best[:, None], 1)[:, 0]
    qend = (best // N).astype(jnp.int32)
    rend = (best % N).astype(jnp.int32)
    qstart = origin // jnp.int32(N + 1)
    rstart = origin % jnp.int32(N + 1)
    zero = score <= 0
    z = jnp.int32(0)
    return {
        "score": jnp.maximum(score, 0),
        "qstart": jnp.where(zero, z, qstart),
        "qend": jnp.where(zero, z, qend),
        "rstart": jnp.where(zero, z, rstart),
        "rend": jnp.where(zero, z, rend),
    }


@partial(jax.jit, static_argnames=("match", "mismatch", "gap_open", "gap_ext"))
def sw_score(query, ref, match=1, mismatch=-2, gap_open=-3, gap_ext=-1):
    """Score-only batched SW (StripedSmithWaterman defaults: match 2? — the
    reference relies on scikit-bio defaults match=2, mismatch=-3, open=5,
    extend=2 but then divides by read length and compares to 0.8; we use
    match=1 so score == matched-base count, the interpretation the reference
    comments state (accurate_bkp.py:36 'the map score is equal to the match
    base number')."""
    B, M = query.shape
    N = ref.shape[1]
    o = jnp.int32(gap_open)
    e = jnp.int32(gap_ext)
    jpos = jnp.arange(N, dtype=jnp.int32)

    def row_step(carry, q):
        H_prev, Mf, i = carry
        sub = jnp.where(
            (ref == q[:, None]) & (ref < 4) & (q[:, None] < 4),
            jnp.int32(match), jnp.int32(mismatch),
        )
        Hd = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), H_prev[:, :-1]], 1)
        F = Mf + o + i * e
        H1 = jnp.maximum(jnp.maximum(Hd + sub, 0), F)
        T = H1 - jpos[None, :] * e
        Tm = jax.lax.associative_scan(jnp.maximum, T, axis=1)
        Tm = jnp.concatenate([jnp.full((B, 1), NEG), Tm[:, :-1]], 1)
        H = jnp.maximum(H1, Tm + o + jpos[None, :] * e)
        Mf = jnp.maximum(Mf, H - i * e)
        return (H, Mf, i + 1), jnp.max(H, axis=1)

    (_, _, _), rowmax = jax.lax.scan(
        row_step,
        (jnp.zeros((B, N), jnp.int32), jnp.full((B, N), NEG), jnp.int32(0)),
        query.T,
    )
    return jnp.maximum(jnp.max(rowmax, axis=0), 0)


SW_TILE = 8192  # max rows per device DP call: the plain path's [M, B, N]
#                 H and origin tensors grow with B (1 GB each at 8192 x 150
#                 x 214 int32)


_FIELDS = ("score", "qstart", "qend", "rstart", "rend")


@partial(jax.jit, static_argnames=("match", "mismatch", "gap_open", "gap_ext"))
def _sw_align_packed(query, ref, match=1, mismatch=-4, gap_open=-6, gap_ext=-1):
    """sw_align with outputs stacked as one int16 [5, B] array: a single
    small device->host copy. Coordinates fit int16 because M, N <= a few
    hundred in every caller."""
    out = sw_align(query, ref, match=match, mismatch=mismatch,
                   gap_open=gap_open, gap_ext=gap_ext)
    return jnp.stack([out[f] for f in _FIELDS]).astype(jnp.int16)


def _sw_align_device(q, r, **kw):
    """Per-device full-span SW: int32 [5, b]. On a GPU the DP runs in the
    Pallas kernel (ops.pallas_sw, no [M, B, N] tensors); elsewhere in the
    lax.scan formulation, which is also the kernel's test reference. Both
    are shard-shape-oblivious, so this also serves inside shard_map."""
    if jax.default_backend() == "gpu":
        from localhgt_tpu.ops import pallas_sw

        return pallas_sw.sw_align_pallas(q, r, **kw)
    return _sw_align_packed(q, r, **kw).astype(jnp.int32)


def _bucket(n: int, tile: int) -> int:
    """Pad size for a sub-batch: a power of two >= 256, capped at `tile`,
    so jit shapes stay few."""
    return tile if n >= tile else max(256, 1 << (n - 1).bit_length())


def sw_align_sharded(mesh, query, ref, **kw):
    """Data-parallel SW over a device mesh: the batch axis is sharded over
    the mesh's first axis with shard_map, each device running the same
    kernel on its rows (the analogue of bwa mem -t fanning reads over
    threads, pipeline.sh:48). Per-row results are independent, so outputs
    are bit-identical to the single-device path. Returns the numpy dict of
    sw_align_tiled."""
    import time as _time

    import numpy as np
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from localhgt_tpu.utils import metrics

    axis = mesh.axis_names[0]
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    B = query.shape[0]
    metrics.add("sw_cells", float(B) * query.shape[1] * ref.shape[1])
    Bp = n_dev * max(256, 1 << (-(-B // n_dev) - 1).bit_length())
    q = np.full((Bp, query.shape[1]), 4, np.uint8)
    q[:B] = np.asarray(query)
    r = np.full((Bp, ref.shape[1]), 4, np.uint8)
    r[:B] = np.asarray(ref)

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(axis), P(axis)),
             out_specs=P(None, axis), check_vma=False)
    def run(qs, rs):
        return _sw_align_device(qs, rs, **kw)

    _t0 = _time.perf_counter()
    packed = np.asarray(run(jnp.asarray(q), jnp.asarray(r)))
    metrics.record("sw_kernel_s", _time.perf_counter() - _t0)
    return {f: packed[i, :B].astype(np.int32)
            for i, f in enumerate(_FIELDS)}


def sw_align_tiled(query, ref, tile: int = SW_TILE, mesh=None, **kw):
    """sw_align in host-tiled sub-batches; returns numpy dict (int32).

    With `mesh`, the batch is sharded over the mesh instead (see
    sw_align_sharded)."""
    import time as _time

    import numpy as np

    from localhgt_tpu.utils import metrics

    if mesh is not None:
        return sw_align_sharded(mesh, query, ref, **kw)

    B = query.shape[0]
    metrics.add("sw_cells", float(B) * query.shape[1] * ref.shape[1])
    parts = []
    for lo in range(0, max(B, 1), tile):
        hi = min(B, lo + tile)
        n = hi - lo
        if n <= 0:
            break
        bucket = _bucket(n, tile)
        q = np.full((bucket, query.shape[1]), 4, np.uint8)
        q[:n] = np.asarray(query[lo:hi])
        r = np.full((bucket, ref.shape[1]), 4, np.uint8)
        r[:n] = np.asarray(ref[lo:hi])
        # the np.asarray below is synchronous, so this wall is the true
        # kernel window (H2D + DP + D2H) — the basis of sw_gcups_kernel
        # (the stage wall mixes in seeding and host work)
        _t0 = _time.perf_counter()
        packed = np.asarray(_sw_align_device(q, r, **kw))
        metrics.record("sw_kernel_s", _time.perf_counter() - _t0)
        parts.append(packed[:, :n])
    if not parts:
        return {f: np.zeros(0, np.int32) for f in _FIELDS}
    packed = np.concatenate(parts, axis=1).astype(np.int32)
    return dict(zip(_FIELDS, packed))


@partial(jax.jit, static_argnames=("match", "mismatch", "gap_open", "gap_ext"))
def _sw_score_i16(query, ref, match=1, mismatch=-2, gap_open=-3, gap_ext=-1):
    return sw_score(query, ref, match=match, mismatch=mismatch,
                    gap_open=gap_open, gap_ext=gap_ext).astype(jnp.int16)


def sw_score_tiled(query, ref, tile: int = SW_TILE, **kw):
    import time as _time

    import numpy as np

    from localhgt_tpu.utils import metrics

    B = query.shape[0]
    metrics.add("sw_cells", float(B) * query.shape[1] * ref.shape[1])
    outs = []
    for lo in range(0, max(B, 1), tile):
        hi = min(B, lo + tile)
        n = hi - lo
        if n <= 0:
            break
        bucket = _bucket(n, tile)
        q = np.full((bucket, query.shape[1]), 4, np.uint8)
        q[:n] = np.asarray(query[lo:hi])
        r = np.full((bucket, ref.shape[1]), 4, np.uint8)
        r[:n] = np.asarray(ref[lo:hi])
        _t0 = _time.perf_counter()
        outs.append(
            np.asarray(_sw_score_i16(q, r, **kw))[:n].astype(np.int32))
        metrics.record("sw_kernel_s", _time.perf_counter() - _t0)
    if not outs:
        return np.zeros(0, np.int32)
    return np.concatenate(outs)


def sw_align_np(query, ref, match=1, mismatch=-4, gap_open=-6, gap_ext=-1):
    """Plain O(MN) numpy DP for tests: returns (score, qs, qe, rs, re)."""
    import numpy as np

    M, N = len(query), len(ref)
    H = np.zeros((M + 1, N + 1), np.int32)
    orig = {}
    best = (0, 0, 0)
    for i in range(1, M + 1):
        for j in range(1, N + 1):
            s = match if (query[i - 1] == ref[j - 1] and query[i - 1] < 4 and ref[j - 1] < 4) else mismatch
            cands = [(0, None)]
            d = H[i - 1, j - 1] + s
            cands.append((d, orig.get((i - 1, j - 1), (i - 1, j - 1))))
            for g in range(1, i):
                cands.append((H[i - g, j] + gap_open + g * gap_ext, orig.get((i - g, j))))
            for g in range(1, j):
                cands.append((H[i, j - g] + gap_open + g * gap_ext, orig.get((i, j - g))))
            v, og = max(cands, key=lambda t: t[0])
            H[i, j] = max(v, 0)
            if H[i, j] > 0:
                orig[(i, j)] = og if og is not None else (i - 1, j - 1)
            if H[i, j] > best[0]:
                best = (int(H[i, j]), i, j)
    if best[0] == 0:
        return 0, 0, 0, 0, 0
    _, i, j = best
    og = orig[(i, j)]
    return best[0], og[0], i - 1, og[1], j - 1
