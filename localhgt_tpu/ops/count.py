"""Saturating k-mer count tables as device arrays.

The reference keeps one `char[2^k]` per run (4 GB at k=32) updated by racy
unsynchronized threads with a saturation cap of 3
(src/extract_ref_normal_peak.cpp:23,1082-1085). The device formulation is a
deterministic scatter-add:

  * per batch, each index's contribution is capped at `cap` by ranking
    duplicates within the sorted batch (so int8 can never overflow), then
  * a scatter-add plus a (deferrable) clip reproduces exactly
    final_count = min(total_occurrences, cap) — the single-threaded reference
    semantics (SURVEY.md section 5 "race detection": the rebuild replaces the
    benign data race with deterministic merges).

Tables are **1-D int8 [2^k]** for k <= 30 (hash indices fit int32) and
**1-D int32 [2^(k-3)]** with eight 4-bit fields per word for k > 30 (word
index h>>3 <= 2^29 fits XLA's int32 scatter/gather indices, so every update
is a 1-D scatter). The single hash value 0xFFFFFFFF
doubles as the invalid sentinel (a degenerate all-ones k-mer code; the
reference similarly treats index 0 as unusable, read_index cpp:936-941).

Multi-chip: per-shard tables merge with a saturating collective
(min(psum(local), cap)) — see localhgt_tpu.parallel.mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from localhgt_tpu.ops import encode

TABLE_BITS = 30   # largest k stored as one count per byte (indices int32)
SENTINEL = jnp.uint32(0xFFFFFFFF)

# k > 30: EIGHT 4-bit saturating fields per int32 word (int32[2^(k-3)] =
# 2 GB at k=32, vs 4 GB one-per-byte — the SURVEY section 7 "pack the
# counts" plan). Word index = h >> 3 <= 2^29, which fits XLA's int32
# scatter/gather indices, so the update stays a 1-D scatter. Convention:
# int8 dtype = plain table, int32 dtype = packed-word table.
PACKED_FIELD_MAX = 15
PACKED_SHIFT_BITS = 3           # 2^3 fields per word


def make_table(k: int) -> jnp.ndarray:
    if k <= TABLE_BITS:
        return jnp.zeros(1 << k, dtype=jnp.int8)
    return jnp.zeros(1 << (k - PACKED_SHIFT_BITS), dtype=jnp.int32)


def is_packed(table) -> bool:
    return table.dtype == jnp.int32


def _packed_field_shift(h):
    """Bit offset of hash h's 4-bit field within its word."""
    return ((h & jnp.uint32(7)) << jnp.uint32(2)).astype(jnp.int32)


def table_lookup(table, h):
    """Gather counts for uint32 hashes from a count table."""
    if is_packed(table):
        word = table[(h >> jnp.uint32(PACKED_SHIFT_BITS)).astype(jnp.int32)]
        return ((word >> _packed_field_shift(h)) & 15).astype(jnp.int8)
    # k <= 30: every hash < 2^30 fits int32; 1-D flat gather
    return table[h.astype(jnp.int32)]


def capped_batch_delta(idx: jnp.ndarray, valid: jnp.ndarray, cap: int):
    """Return (sorted_idx, delta int8) with per-index delta = min(count, cap).

    Invalid entries map to SENTINEL and are dropped at scatter time.
    """
    s, contrib = capped_batch_delta_multi(
        idx.reshape(1, -1), valid.reshape(-1), cap
    )
    return s[0], contrib[0]


def rank_capped_contrib(s: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Per-entry int8 contribution from SORTED hashes s [C, N]: the first
    `cap` entries of each run contribute 1, the rest 0 — so the scatter-add
    total per hash is exactly min(run_length, cap). The single shared
    post-sort kernel of both count paths (r4 ADVICE: count_reads_step had
    inlined a drifting copy)."""
    C, N = s.shape
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (C, N))
    is_start = jnp.concatenate(
        [jnp.ones((C, 1), bool), s[:, 1:] != s[:, :-1]], axis=1)
    run_start = jax.lax.cummax(jnp.where(is_start, pos, 0), axis=1)
    return (((pos - run_start) < cap) & (s != SENTINEL)).astype(jnp.int8)


def capped_batch_delta_multi(idx: jnp.ndarray, valid: jnp.ndarray, cap: int):
    """Batched variant: idx [C, N] (one row per hash function), valid [N].

    One vectorized sort over the row axis instead of C separate sorts — the
    XLA sort is the compile-time hog of the count step (~16 s per instance on
    this backend), so batching it cuts cold-start by ~2x.
    """
    flat = jnp.where(valid.reshape(1, -1), idx.reshape(idx.shape[0], -1)
                     .astype(jnp.uint32), SENTINEL)
    s = jnp.sort(flat, axis=1)
    return s, rank_capped_contrib(s, cap)


def scatter_delta(table, s, contrib):
    """Scatter sorted hashes + capped deltas into a count table.

    The flat path is a 1-D scatter. Sentinels map to a positive
    out-of-bounds index, which the scatter drops (mode="drop").

    Packed tables scatter `contrib << 4*(h&7)` into word h>>3 (1-D int32
    scatter); per-batch field totals are <= cap (rank-capped), so no carry
    can cross fields as long as clip_tables runs before a field exceeds
    PACKED_FIELD_MAX."""
    n = table.shape[0]
    if is_packed(table):
        idx = jnp.where(
            s == SENTINEL, jnp.int32(n),
            (s >> jnp.uint32(PACKED_SHIFT_BITS)).astype(jnp.int32))
        val = contrib.astype(jnp.int32) << _packed_field_shift(s)
        return table.at[idx].add(val, mode="drop")
    lo = jnp.where(s == SENTINEL, jnp.int32(n), s.astype(jnp.int32))
    return table.at[lo].add(contrib, mode="drop")


def count_batch(table, hashes, valid, cap: int = 3):
    """Scatter one batch of canonical hashes into the count table."""
    s, contrib = capped_batch_delta(hashes, valid, cap)
    table = scatter_delta(table, s, contrib)
    return jnp.minimum(table, jnp.int8(cap))


def sorted_run_deltas(s: jnp.ndarray, cap: int):
    """Per-unique-hash batch deltas from sorted hashes.

    NOT on the production path (tools/micro_count.py only); see
    count_reads_step.

    s: uint32 [C, N] sorted ascending per row (SENTINEL tail). Returns
    (live bool [C, N], delta int32 [C, N]): live marks the FIRST entry of
    each hash run; delta there = min(run_length, cap) — identical to the
    sum of the rank-capped per-entry contribs, but emitted at ONE entry
    per unique hash so the scatter can declare `unique_indices` and skip
    XLA's conflict serialization. Run length = next run start - own start, via
    a suffix-min of start positions."""
    C, N = s.shape
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (C, N))
    is_start = jnp.concatenate(
        [jnp.ones((C, 1), bool), s[:, 1:] != s[:, :-1]], axis=1)
    arr = jnp.where(is_start, pos, jnp.int32(N))
    suf = jnp.flip(jax.lax.cummin(jnp.flip(arr, axis=1), axis=1), axis=1)
    nxt = jnp.concatenate(
        [suf[:, 1:], jnp.full((C, 1), N, jnp.int32)], axis=1)
    delta = jnp.minimum(nxt - pos, cap).astype(jnp.int32)
    return is_start & (s != SENTINEL), delta


def scatter_unique(table, s, live, delta):
    """Scatter per-unique-hash deltas (sorted_run_deltas output) with
    unique indices. NOT on the production path (tools/micro_count.py
    only) — see sorted_run_deltas.

    Plain (k <= 30) tables: live entries have distinct hashes, so the
    int8 scatter is directly unique. Packed tables: distinct hashes can
    share a word, so the scatter splits by FIELD (s & 7) — within one
    field, distinct hashes imply distinct words, making each of the 8
    scatters unique (dead entries route to the positive out-of-bounds
    slot and drop)."""
    n = table.shape[0]
    if is_packed(table):
        word = (s >> jnp.uint32(PACKED_SHIFT_BITS)).astype(jnp.int32)
        field = (s & jnp.uint32(7)).astype(jnp.int32)
        for f in range(1 << PACKED_SHIFT_BITS):
            sel = live & (field == f)
            idx = jnp.where(sel, word, jnp.int32(n))
            val = jnp.where(sel, delta << (4 * f), 0)
            table = table.at[idx].add(val, mode="drop", unique_indices=True)
        return table
    idx = jnp.where(live, s.astype(jnp.int32), jnp.int32(n))
    val = jnp.where(live, delta, 0).astype(jnp.int8)
    return table.at[idx].add(val, mode="drop", unique_indices=True)


@partial(jax.jit, static_argnames=("k", "cap", "clip", "kw"),
         donate_argnums=(0,))
def count_reads_step(tables, codes, lengths, accept, masks, k: int,
                     cap: int = 3, clip: bool = True, kw: int = 0):
    """One fused device step: hash a read batch and update all hash tables.

    Fully jitted (single dispatch per batch) and donating the tables so
    updates are in-place.

    clip=False defers the saturating sweep: per-batch deltas are <= cap, so
    int8 values stay bounded for ~(127/cap) batches and a periodic
    clip_tables() restores min(total, cap) exactly (deltas of k-mers below
    cap are uncapped, so the final clip loses nothing).

    kw (static) crops the k-mer start axis to the batch's real window
    (max_len - k + 1 rounded to 64) before the sort — the padded read
    width is typically 192 for 150-bp reads whose last valid start is
    118, so cropping cuts the sort (the dominant device cost) by ~1/3.
    0 = no crop.
    """
    hashes, valid = encode.canonical_hashes(jnp, codes, masks, k)
    L = codes.shape[-1]
    if kw and kw < L:
        hashes = hashes[:, :, :kw]
        valid = valid[:, :kw]
        L = kw
    j = jnp.arange(L, dtype=jnp.int32)
    inwin = j[None, :] <= (lengths[:, None] - k)
    valid = valid & inwin & accept[:, None]
    C = hashes.shape[0]
    flat = jnp.where(valid.reshape(1, -1),
                     hashes.reshape(C, -1).astype(jnp.uint32), SENTINEL)
    s_all = jnp.sort(flat, axis=1)
    # rank-capped per-entry contribs + ONE conflict-serialized scatter per
    # table; the per-unique-hash variant (scatter_unique, 8 per-field
    # unique scatters on packed tables) is the alternative that
    # tools/micro_count.py compares against it. Not yet measured on a GPU.
    contrib = rank_capped_contrib(s_all, cap)
    new_tables = []
    for i, t in enumerate(tables):
        t = scatter_delta(t, s_all[i], contrib[i])
        if clip:
            t = jnp.minimum(t, jnp.int8(cap))
        new_tables.append(t)
    return tuple(new_tables)


@partial(jax.jit, static_argnames=("cap",), donate_argnums=(0,))
def clip_tables(tables, cap: int = 3):
    out = []
    for t in tables:
        if is_packed(t):
            acc = jnp.zeros_like(t)
            for f in range(1 << PACKED_SHIFT_BITS):
                fld = (t >> (4 * f)) & 15
                acc = acc | (jnp.minimum(fld, cap) << (4 * f))
            out.append(acc)
        else:
            out.append(jnp.minimum(t, jnp.int8(cap)))
    return tuple(out)


def clip_every_batches(k: int, cap: int = 3) -> int:
    """How many un-clipped batches the table dtype can absorb: int8 has
    127/cap headroom; a packed 4-bit field only (15-cap)/cap.

    Packed tables require cap <= 7: a clipped field holds <= cap and one
    batch adds <= cap more, so cap >= 8 could push a field past 15 and carry
    into the neighboring hash's nibble even with clipping every batch."""
    if k > TABLE_BITS:
        if cap > (PACKED_FIELD_MAX - 1) // 2:
            raise ValueError(
                f"least_depth={cap} > 7 overflows the 4-bit packed count "
                f"fields used for k={k} > {TABLE_BITS}; use k <= "
                f"{TABLE_BITS} or a smaller least_depth")
        return max(1, (PACKED_FIELD_MAX - cap) // max(cap, 1))
    return max(1, 120 // max(cap, 1) - 2)


def table_lookup_np(table_host, h):
    """Host-side lookup on np.asarray(table) (plain or packed)."""
    import numpy as np

    h = np.asarray(h, dtype=np.int64)
    if table_host.dtype == np.int32:  # packed word table
        word = table_host.reshape(-1)[h >> PACKED_SHIFT_BITS]
        return ((word >> ((h & 7) * 4)) & 15).astype(np.int8)
    return table_host.reshape(-1)[h]
