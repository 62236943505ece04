#!/usr/bin/env python3
"""Microbenchmark of the stage-A count step on the device.

Splits the per-batch device wall into: H2D transfer, hash, sort, delta,
scatter — so the count stage is attributable to one op.
Usage: python tools/micro_count.py [k]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def t(fn, *a, n=3, **kw):
    import jax

    out = fn(*a, **kw)
    jax.block_until_ready(out)
    best = 1e9
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    import jax
    import jax.numpy as jnp

    from functools import partial

    from localhgt_tpu.ops import count, encode

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    B, L = 1 << 16, 192
    kw_crop = 128
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = np.full(B, 150, np.int32)
    accept = np.ones(B, bool)
    masks, _ = encode.hasher_for(k, 3, 1)
    masks_j = jnp.asarray(masks)

    print(f"k={k} batch [{B},{L}] crop {kw_crop}", flush=True)

    # H2D: plain uint8 codes
    dt, _ = t(lambda c: jax.block_until_ready(jnp.asarray(c)), codes, n=3)
    print(f"h2d_codes_uint8 {codes.nbytes/2**20:.1f}MB: {dt*1e3:.0f} ms "
          f"({codes.nbytes/dt/2**20:.0f} MB/s)", flush=True)

    # H2D: 2-bit packed
    packed = (codes[:, 0::4] & 3) | ((codes[:, 1::4] & 3) << 2) | \
        ((codes[:, 2::4] & 3) << 4) | ((codes[:, 3::4] & 3) << 6)
    dt, _ = t(lambda c: jax.block_until_ready(jnp.asarray(c)), packed, n=3)
    print(f"h2d_codes_packed2 {packed.nbytes/2**20:.1f}MB: {dt*1e3:.0f} ms",
          flush=True)

    codes_j = jnp.asarray(codes)
    lengths_j = jnp.asarray(lengths)
    acc_j = jnp.asarray(accept)

    # full step (donated tables)
    tables = tuple(count.make_table(k) for _ in range(3))
    t0 = time.perf_counter()
    tables = count.count_reads_step(tables, codes_j, lengths_j, acc_j,
                                    masks_j, k, 3, clip=False, kw=kw_crop)
    jax.block_until_ready(tables)
    print(f"count_reads_step first: {time.perf_counter()-t0:.1f} s", flush=True)
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        tables = count.count_reads_step(tables, codes_j, lengths_j, acc_j,
                                        masks_j, k, 3, clip=False, kw=kw_crop)
        jax.block_until_ready(tables)
        best = min(best, time.perf_counter() - t0)
    print(f"count_reads_step steady: {best*1e3:.0f} ms", flush=True)

    # pieces
    @partial(jax.jit, static_argnames=("k", "kw"))
    def hash_only(codes, lengths, accept, masks, k, kw):
        hashes, valid = encode.canonical_hashes(jnp, codes, masks, k)
        hashes = hashes[:, :, :kw]
        valid = valid[:, :kw]
        j = jnp.arange(kw, dtype=jnp.int32)
        inwin = j[None, :] <= (lengths[:, None] - k)
        valid = valid & inwin & accept[:, None]
        C = hashes.shape[0]
        return jnp.where(valid.reshape(1, -1),
                         hashes.reshape(C, -1).astype(jnp.uint32),
                         count.SENTINEL)

    dt, flat = t(hash_only, codes_j, lengths_j, acc_j, masks_j, k, kw_crop)
    print(f"hash: {dt*1e3:.0f} ms  flat {flat.shape}", flush=True)

    sort_j = jax.jit(lambda f: jnp.sort(f, axis=1))
    dt, s_all = t(sort_j, flat)
    print(f"sort [3,{flat.shape[1]}]: {dt*1e3:.0f} ms", flush=True)

    delta_j = jax.jit(partial(count.sorted_run_deltas, cap=3))
    dt, (live, delta) = t(delta_j, s_all)
    print(f"run_deltas: {dt*1e3:.0f} ms", flush=True)

    # scatter_unique (8-field split for packed)
    tbl = count.make_table(k)

    @jax.jit
    def sc_unique(tbl, s, live, delta):
        return count.scatter_unique(tbl, s, live, delta)

    dt, tbl = t(sc_unique, tbl, s_all[0], live[0], delta[0])
    print(f"scatter_unique x1 table: {dt*1e3:.0f} ms", flush=True)

    # old conflict-serialized scatter
    tbl2 = count.make_table(k)

    @jax.jit
    def sc_old(tbl, s, contrib):
        return count.scatter_delta(tbl, s, contrib)

    contrib = (live[0] & (delta[0] > 0)).astype(jnp.int8)
    dt, tbl2 = t(sc_old, tbl2, s_all[0], contrib)
    print(f"scatter_delta(old) x1 table: {dt*1e3:.0f} ms", flush=True)

    # unpacked-int8 comparison path (k<=30 table) at same volume
    if k > 30:
        tbl3 = jnp.zeros(1 << 30, jnp.int8)
        s30 = (s_all[0] >> jnp.uint32(2)).astype(jnp.uint32)

        @jax.jit
        def sc_int8(tbl, s, live, delta):
            n = tbl.shape[0]
            idx = jnp.where(live, s.astype(jnp.int32), jnp.int32(n))
            val = jnp.where(live, delta, 0).astype(jnp.int8)
            return tbl.at[idx].add(val, mode="drop", unique_indices=True)

        dt, _ = t(sc_int8, tbl3, s30, live[0], delta[0])
        print(f"scatter int8 2^30 x1 table: {dt*1e3:.0f} ms", flush=True)


if __name__ == "__main__":
    main()
