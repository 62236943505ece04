"""Bit-sliced canonical k-mer hashing — the vectorized device formulation.

The reference computes each k-mer hash with k scalar table lookups and adds per
position per hash function (read_fastq inner loop,
src/extract_ref_normal_peak.cpp:1052-1086; same loop repeated in read_ref and
Peaks::slide_reads). Because every hash bit is a *binary* partition value of
one base, the whole k-mer index is recoverable from three per-partition bit
streams:

1. For each partition p in {0,1,2}, compute bit stream B_p[t] in {0,1}.
2. Pack sliding windows W_p[j] = sum_z B_p[j+z] << (k-1-z) with a log-doubling
   recurrence W_{a+b}[j] = (W_a[j] << b) | W_b[j+a]  — O(log k) vector ops.
3. Hash i is then three ANDs + two ORs with precomputed per-hash masks
   (localhgt_tpu.ops.coder.hash_masks).
4. The reverse-complement index is a bit reversal: complementing a base keeps
   partition 0 and flips partitions 1 and 2, so the packed windows of the
   complement stream are W_0, ~W_1, ~W_2, and reversing the window order is a
   k-bit integer bit-reversal.

Net cost: ~80 uint32 elementwise ops per position for all three hash functions
(vs ~600 scalar ops in the reference), with no per-position memory traffic.
This also eliminates the reference's persistent hash index
(<ref>.k32.h3.index.dat, ~12x the reference size, README.md:126): re-hashing
the packed reference on the fly is cheaper than streaming that file.

All functions take `xp` (numpy or jax.numpy) so the identical arithmetic runs
on host (tests, sparse re-hashing) and device (bulk pipeline).
"""

from __future__ import annotations

import numpy as np

from localhgt_tpu.ops import coder


def _shift_left(xp, x, m: int):
    """y[..., j] = x[..., j+m], zero-filled at the tail."""
    if m == 0:
        return x
    pad = xp.zeros(x.shape[:-1] + (m,), dtype=x.dtype)
    return xp.concatenate([x[..., m:], pad], axis=-1)


def partition_bits(xp, codes):
    """Base codes [..., L] -> three {0,1} uint32 partition streams + valid.

    Partition truth table (coder.PARTITIONS; reference generate_coder,
    cpp:1109-1154) with codes A=0,C=1,G=2,T=3:
        p0 = 1 for A,T;  p1 = 1 for A,C;  p2 = 1 for A,G
    """
    c = codes.astype(xp.uint32)
    valid = (c < 4).astype(xp.uint32)
    p1 = (c < 2).astype(xp.uint32)             # A,C
    p2 = ((c & 1) ^ 1) & valid                 # A,G (even codes), N excluded
    p0 = ((c == 0) | (c == 3)).astype(xp.uint32)   # A,T
    return (p0, p1, p2), valid


def packed_windows(xp, bits, k: int):
    """W[j] = sum_{z<k} bits[j+z] << (k-1-z), uint32, log-doubling build."""
    pows = {1: bits.astype(xp.uint32)}
    m = 1
    while 2 * m <= k:
        w = pows[m]
        pows[2 * m] = (w << np.uint32(m)) | _shift_left(xp, w, m)
        m *= 2
    acc = None
    done = 0
    for p in sorted(pows, reverse=True):
        if k & p:
            piece = _shift_left(xp, pows[p], done)
            acc = piece if acc is None else ((acc << np.uint32(p)) | piece)
            done += p
    return acc


def bitrev_k(xp, x, k: int):
    """Reverse the low-k bits of a uint32 (bits >= k must be zero)."""
    u = np.uint32
    x = ((x & u(0x55555555)) << u(1)) | ((x >> u(1)) & u(0x55555555))
    x = ((x & u(0x33333333)) << u(2)) | ((x >> u(2)) & u(0x33333333))
    x = ((x & u(0x0F0F0F0F)) << u(4)) | ((x >> u(4)) & u(0x0F0F0F0F))
    x = ((x & u(0x00FF00FF)) << u(8)) | ((x >> u(8)) & u(0x00FF00FF))
    x = (x << u(16)) | (x >> u(16))
    if k < 32:
        x = x >> u(32 - k)
    return x


def canonical_hashes(xp, codes, masks, k: int):
    """Canonical (min of strand) k-mer hashes for every window start.

    Args:
        xp: numpy or jax.numpy.
        codes: uint8 base codes, shape [..., L].
        masks: uint32 [coder_num, 3] per-hash partition-selection masks
            (coder.hash_masks; cast to uint32 by the caller or here).
        k: k-mer length, 1..32.

    Returns:
        hashes: uint32 [coder_num, ..., L]; positions j > L-k contain garbage.
        valid: bool [..., L]; True iff window j is fully A/C/G/T and j <= L-k.

    Matches reference semantics (cpp:426-452): canonical = min(forward,
    revcomp); any non-ACGT base in the window invalidates it.
    """
    kmask = np.uint32((1 << k) - 1) if k < 32 else np.uint32(0xFFFFFFFF)
    (p0, p1, p2), validbit = partition_bits(xp, codes)
    w0 = packed_windows(xp, p0, k)
    w1 = packed_windows(xp, p1, k)
    w2 = packed_windows(xp, p2, k)
    # complement stream windows: p0 invariant, p1/p2 flipped
    r0 = bitrev_k(xp, w0, k)
    r1 = bitrev_k(xp, (~w1) & kmask, k)
    r2 = bitrev_k(xp, (~w2) & kmask, k)

    vwin = packed_windows(xp, validbit, k)
    L = codes.shape[-1]
    # window must be all-valid and fully inside the sequence
    j = xp.arange(L, dtype=xp.int32)
    inside = j <= (L - k)
    valid = (vwin == kmask) & inside

    masks = masks.astype(xp.uint32) if hasattr(masks, "astype") else masks
    outs = []
    for i in range(masks.shape[0]):
        m0, m1, m2 = masks[i, 0], masks[i, 1], masks[i, 2]
        fwd = (w0 & m0) | (w1 & m1) | (w2 & m2)
        rev = (r0 & m0) | (r1 & m1) | (r2 & m2)
        outs.append(xp.minimum(fwd, rev))
    return xp.stack(outs, axis=0), valid


def hasher_for(k: int, coder_num: int, seed: int):
    """Convenience: returns (masks uint32 [coder_num,3], choose_coder)."""
    cc = coder.choose_coder(k, coder_num, seed)
    masks = coder.hash_masks(cc, k).astype(np.uint32)
    return masks, cc
