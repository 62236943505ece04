"""Sizes of the resident device structures of the production k=32
configuration: every one is a flat 1-D array whose bytes are exactly its
logical size, checked without allocating, plus a device rank-map build big
enough that a mis-sized structure would show."""

import numpy as np


def test_k32_resident_structures_are_lane_efficient():
    """The packed count table and the rank map at k=32 are 1-D arrays of
    the planned sizes (shape-only check: jax.eval_shape, no allocation)."""
    import jax

    from localhgt_tpu.ops import count as count_mod
    from localhgt_tpu.pipeline import peaks as pm

    k = 32
    table = jax.eval_shape(lambda: count_mod.make_table(k))
    assert table.shape == (1 << (k - count_mod.PACKED_SHIFT_BITS),)
    assert table.dtype == np.int32
    assert table.size * table.dtype.itemsize == 2 << 30      # 2 GiB
    # rank map: interleaved (word, prefix) int32 pairs over 2^(k-5) words
    W = 1 << (k - 5)
    assert 2 * W * 4 == 1 << 30                               # wp: 1 GiB
    assert pm._pids_cap(240_000_000) % 128 == 0


def test_rankmap_device_build_at_packed_size():
    """Force the device rank-map build at a bitmap big enough that a padded
    layout would blow past any unit-test budget (2^26-hash space, >= 2^20
    stored keys), then verify lookups — runnable on CPU because every
    array is 1-D."""
    import jax.numpy as jnp

    from localhgt_tpu.pipeline import peaks as pm

    k = 26
    rng = np.random.default_rng(0)
    hs = np.unique(rng.integers(1, 1 << k, 1 << 20).astype(np.uint32))
    ps = (np.arange(len(hs), dtype=np.int32) % 100_000) + 1
    B = len(hs) // 3 + 1
    batches = [(jnp.asarray(hs[i * B:(i + 1) * B]),
                jnp.asarray(ps[i * B:(i + 1) * B])) for i in range(3)]
    rm = pm.build_rankmap_device(lambda: iter(batches), k)
    assert np.asarray(rm.wp).ndim == 1 and np.asarray(rm.pids).ndim == 1
    assert np.asarray(rm.wp).shape == (2 << (k - 5),)
    sel = rng.choice(len(hs), 4096, replace=False)
    got = np.asarray(pm.rank_lookup(jnp.asarray(np.asarray(rm.wp)),
                                    jnp.asarray(np.asarray(rm.pids)),
                                    jnp.asarray(hs[sel])))
    np.testing.assert_array_equal(got, ps[sel])
