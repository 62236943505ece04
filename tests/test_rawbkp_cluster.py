"""Raw-junction clustering: DBSCAN(eps, min_samples=1) without scikit-learn.

rawbkp._dbscan_labels must give exactly the labels of the brute-force
definition (connected components of the eps-ball graph, distance <= eps,
numbered by first appearance) and of sklearn's DBSCAN where it is installed.
"""

import zlib

import numpy as np
import pytest

from localhgt_tpu.pipeline.rawbkp import _dbscan_labels


def _oracle(xy: np.ndarray, eps: float) -> np.ndarray:
    n = len(xy)
    label = np.full(n, -1, np.int64)
    nxt = 0
    for i in range(n):
        if label[i] >= 0:
            continue
        label[i] = nxt
        stack = [i]
        while stack:
            a = stack.pop()
            for b in range(n):
                if label[b] < 0 and np.hypot(*(xy[a] - xy[b])) <= eps:
                    label[b] = nxt
                    stack.append(b)
        nxt += 1
    return label


def _case(name: str):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "empty":
        return np.zeros((0, 2)), 225.0
    if name == "single":
        return np.array([[1000.0, 5000.0]]), 225.0
    if name == "ties_at_eps":
        # a chain whose links are exactly eps long (joined), then a point
        # just past eps (separate); axis-aligned and 3-4-5 diagonal links
        return np.array([[0, 0], [225, 0], [225, 225], [360, 405],
                         [360, 630.001]], float), 225.0
    if name == "duplicates":
        base = rng.integers(0, 5000, (6, 2)).astype(float)
        return base[rng.integers(0, 6, 40)], 100.0
    if name == "chained_out_of_order":
        x = np.arange(0, 2000, 150, dtype=float)
        xy = np.stack([x, x * 0 + 7], 1)
        return xy[rng.permutation(len(xy))], 150.0
    if name == "random_dense":
        return rng.integers(0, 3000, (300, 2)).astype(float), 120.0
    if name == "random_sparse":
        return rng.integers(0, 10 ** 6, (200, 2)).astype(float), 300.0
    raise KeyError(name)


CASES = ["empty", "single", "ties_at_eps", "duplicates",
         "chained_out_of_order", "random_dense", "random_sparse"]


@pytest.mark.parametrize("name", CASES)
def test_matches_bruteforce_oracle(name):
    xy, eps = _case(name)
    np.testing.assert_array_equal(_dbscan_labels(xy, eps), _oracle(xy, eps))


@pytest.mark.parametrize("name", CASES)
def test_matches_sklearn(name):
    cluster = pytest.importorskip("sklearn.cluster")
    xy, eps = _case(name)
    if len(xy) == 0:  # sklearn's DBSCAN rejects an empty input
        assert len(_dbscan_labels(xy, eps)) == 0
        return
    want = cluster.DBSCAN(eps=eps, min_samples=1).fit(xy).labels_
    np.testing.assert_array_equal(_dbscan_labels(xy, eps), want)


def test_ties_at_eps_join():
    xy, eps = _case("ties_at_eps")
    assert _dbscan_labels(xy, eps).tolist() == [0, 0, 0, 0, 1]
