"""Pallas SW align kernel vs the lax.scan formulation and the numpy oracle
(interpret mode on the CPU; compiled on a GPU under the `gpu` marker)."""

import numpy as np
import pytest

from localhgt_tpu.ops import sw


def _align(q, r, interpret=True, **kw):
    import jax.numpy as jnp

    from localhgt_tpu.ops import pallas_sw

    return np.asarray(pallas_sw.sw_align_pallas(
        jnp.asarray(q), jnp.asarray(r), interpret=interpret, **kw))


def _expect(q, r, **kw):
    import jax.numpy as jnp

    exp = sw.sw_align(jnp.asarray(q), jnp.asarray(r), **kw)
    return np.stack([np.asarray(exp[f]) for f in sw._FIELDS])


def _planted(seed, B, M, N):
    """Exact hits (span recovery), duplicate plants (flat-argmax ties), N
    runs in reads and all-N windows (zero-score rows)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for b in range(0, B, 5):
        lo = min(30, max(0, N - M))
        r[b, lo:lo + M] = q[b][: min(M, N - lo)]
    w = min(16, M // 2, N // 4)
    for b in range(1, B, 11):
        r[b, 2:2 + w] = q[b][1:1 + w]
        r[b, N - w - 1:N - 1] = q[b][1:1 + w]
    q[2 % B, : M // 2] = 4
    r[min(7, B - 1), :] = 4
    return q, r


def test_pallas_sw_align_matches_scan():
    """The kernel must reproduce the lax.scan formulation's score AND all
    four span coordinates, including its flat-argmax (first-maximum)
    tie-breaking."""
    q, r = _planted(1, 128, 48, 128)
    np.testing.assert_array_equal(_align(q, r), _expect(q, r))


@pytest.mark.parametrize("B,M,N", [
    (1, 8, 8),        # one pair: a 31-pair pad block
    (33, 20, 13),     # B past one block; N below the unroll width
    (40, 150, 214),   # production widths (read vs L + 2 * window_pad)
    (64, 64, 24),     # query longer than the window
    (70, 48, 61),     # N not a multiple of the unroll width
])
def test_sw_align_kernel_shapes(B, M, N):
    q, r = _planted(B * 1000 + N, B, M, N)
    np.testing.assert_array_equal(_align(q, r), _expect(q, r))


@pytest.mark.parametrize("kw", [
    dict(match=2, mismatch=-3, gap_open=-5, gap_ext=-2),
    dict(match=1, mismatch=-1, gap_open=-1, gap_ext=-1),
    dict(match=3, mismatch=-2, gap_open=-8, gap_ext=0),
])
def test_sw_align_kernel_gap_params(kw):
    rng = np.random.default_rng(4)
    B, M, N = 48, 40, 72
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for b in range(B):  # reads with an indel relative to their window
        seg = rng.integers(0, 4, 50).astype(np.uint8)
        r[b, 10:60] = seg
        q[b, :36] = (np.concatenate([seg[:12], seg[15:39]]) if b % 2
                     else np.concatenate([seg[:12], [3, 3, 3], seg[12:33]]))
    np.testing.assert_array_equal(_align(q, r, **kw), _expect(q, r, **kw))


def test_pallas_sw_align_gap_costs():
    """Affine-gap parameters thread through the kernel (non-default
    match/mismatch/open/ext), checked against the numpy oracle."""
    rng = np.random.default_rng(2)
    M, N = 32, 64
    q = rng.integers(0, 4, (64, M)).astype(np.uint8)
    r = rng.integers(0, 4, (64, N)).astype(np.uint8)
    # queries with a deletion relative to ref: force gap handling
    for b in range(64):
        seg = rng.integers(0, 4, 40).astype(np.uint8)
        r[b, 10:50] = seg
        q[b, :30] = np.concatenate([seg[:12], seg[18:36]])
    kw = dict(match=2, mismatch=-3, gap_open=-5, gap_ext=-2)
    got = _align(q, r, **kw)
    for b in range(0, 64, 9):
        s, qs, qe, rs, re_ = sw.sw_align_np(q[b], r[b], **kw)
        assert got[0, b] == s, b
        if s > 0:
            assert tuple(got[1:, b]) == (qs, qe, rs, re_), b


@pytest.mark.parametrize("n,tile,want", [
    (1, 8192, 256), (256, 8192, 256), (257, 8192, 512),
    (5000, 8192, 8192), (8192, 8192, 8192), (9000, 8192, 8192),
])
def test_sw_bucket(n, tile, want):
    assert sw._bucket(n, tile) == want


def test_sw_align_tiled_spans_tiles():
    """Host tiling (sub-batches, pow2 padding) returns the untiled
    result on the plain CPU path."""
    q, r = _planted(5, 300, 24, 40)
    got = sw.sw_align_tiled(q, r, tile=128)
    want = _expect(q, r)
    for i, f in enumerate(sw._FIELDS):
        np.testing.assert_array_equal(got[f], want[i], err_msg=f)


@pytest.mark.gpu
def test_sw_align_kernel_compiled_on_gpu():
    q, r = _planted(6, 512, 150, 214)
    np.testing.assert_array_equal(_align(q, r, interpret=False),
                                  _expect(q, r))
