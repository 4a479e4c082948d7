"""Brute-force NN search vs naive numpy loops.

The reference's nn_search.hpp is an unbuildable vestige (missing
euclidean.hpp include), so there is no compiled oracle; the ground
truth here is the definitionally-correct per-row numpy loop, exactly
the semantics of nn_search.hpp's simple:: namespace (radius:72-85,
onenn:87-99, knn:101-121).
"""

import numpy as np
import pytest

from sprintz_jax import search


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(16)
    X = rng.integers(-40, 41, (257, 24)).astype(np.float32)
    Q = rng.integers(-40, 41, (9, 24)).astype(np.float32)
    return X, Q


def naive_dists(X, q):
    return ((X.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)


def test_squared_dists_matches_naive(data):
    X, Q = data
    d = np.asarray(search.squared_dists(X, Q))
    want = np.stack([naive_dists(X, q) for q in Q], axis=1)
    np.testing.assert_allclose(d, want, rtol=0, atol=1e-3)


def test_squared_dists_precomputed_norms(data):
    X, Q = data
    xn = search.row_norms_sq(X)
    np.testing.assert_array_equal(
        np.asarray(search.squared_dists(X, Q, x_norms=xn)),
        np.asarray(search.squared_dists(X, Q)))


def test_onenn_and_knn(data):
    X, Q = data
    for q in Q:
        want = naive_dists(X, q)
        nb = search.onenn(X, q)
        assert nb.idx == int(np.argmin(want))
        assert nb.dist == pytest.approx(want[nb.idx], abs=1e-3)
        got = search.knn(X, q, 5)
        order = np.argsort(want, kind="stable")[:5]
        assert [n.dist for n in got] == sorted(n.dist for n in got)
        assert {n.idx for n in got} == set(
            int(i) for i in order) or np.allclose(
            [n.dist for n in got], want[order], atol=1e-3)


def test_knn_batch_matches_single(data):
    X, Q = data
    batch = search.knn_batch(X, Q, 3)
    for q, nbs in zip(Q, batch):
        single = search.knn(X, q, 3)
        assert [n.idx for n in nbs] == [n.idx for n in single]


def test_knn_k_larger_than_n():
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = search.knn(X, X[2], 10)
    assert len(got) == 4
    assert got[0].idx == 2 and got[0].dist == 0.0


def test_radius_matches_naive(data):
    X, Q = data
    r = float(np.median(naive_dists(X, Q[0])))
    lists = search.radius_batch(X, Q, r)
    for q, nbs in zip(Q, lists):
        want = naive_dists(X, q)
        want_idx = set(np.nonzero(want < r)[0].tolist())
        assert {n.idx for n in nbs} == want_idx
        dists = [n.dist for n in nbs]
        assert dists == sorted(dists)


def test_radius_single_is_batch_row0(data):
    X, Q = data
    r = 5000.0
    assert ([n.idx for n in search.radius(X, Q[0], r)]
            == [n.idx for n in search.radius_batch(X, Q, r)[0]])


def test_knn_tiled_matches_untiled(data):
    X, Q = data
    for tile in (64, 100, 257, 4096):
        tiled = search.knn_tiled(X, Q, 4, tile_rows=tile)
        plain = search.knn_batch(X, Q, 4)
        for a, b in zip(tiled, plain):
            assert [n.dist for n in a] == pytest.approx(
                [n.dist for n in b], abs=1e-3), tile


def test_knn_tiled_pad_rows_never_returned():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(7, 5)).astype(np.float32)
    out = search.knn_tiled(X, X[:2], 7, tile_rows=4)  # pads 7 -> 8
    for nbs in out:
        assert len(nbs) == 7
        assert all(0 <= n.idx < 7 for n in nbs)
