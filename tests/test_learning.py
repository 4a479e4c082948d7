"""greedy_brute_filters == a direct numpy rendering of the reference
semantics (learning.py:253-398) on small grids."""

import numpy as np
import pytest

from sprintz_jax.models.learning import (
    all_possible_filters,
    greedy_brute_filters,
)


def _numpy_greedy(x, nfilters, ntaps, nbits, step_sz, block_sz, loss):
    """Straight numpy implementation of the reference's objective."""
    block_sz = max(1, block_sz)
    x = np.asarray(x, np.float32).reshape(-1)
    X = np.stack([x[i: len(x) - ntaps + i] for i in range(ntaps)], 1)
    y = x[ntaps:]
    X = X[: len(y)]
    cands = all_possible_filters(ntaps, nbits, step_sz)

    def blockify(e):
        # per-sample loss -> sliding length-block_sz window reduction
        per = e * e if loss == "l2" else np.abs(e)
        if block_sz <= 1:
            return per
        n = per.shape[0] - block_sz + 1
        w = np.stack([per[i: i + n] for i in range(block_sz)])
        return w.max(0) if loss == "linf" else w.sum(0)

    best = blockify(y)
    filters = []
    for _ in range(nfilters):
        errs = y[:, None] - X @ cands.T
        bl = blockify(errs)
        means = np.minimum(bl, best[:, None]).mean(0)
        b = int(np.argmin(means))
        filters.append(cands[b])
        best = np.minimum(best, bl[:, b])
    return np.stack(filters)


@pytest.mark.parametrize("loss,block_sz", [
    ("l2", 1), ("l2", 4), ("l1", 1), ("linf", 4)])
def test_matches_reference_semantics(rng, loss, block_sz):
    x = np.cumsum(rng.normal(0, 1, 600)).astype(np.float32)
    got = greedy_brute_filters(x, nfilters=3, ntaps=2, nbits=3,
                               step_sz=0.5, block_sz=block_sz, loss=loss,
                               chunk=16)
    want = _numpy_greedy(x, 3, 2, 3, 0.5, block_sz, loss)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_learns_delta_for_random_walk(rng):
    """On a pure random walk the best 2-tap predictor is 'previous
    value' (delta coding: taps [0, 1])."""
    x = np.cumsum(rng.normal(0, 1, 4000)).astype(np.float32)
    f = greedy_brute_filters(x, nfilters=1, ntaps=2, nbits=3,
                             step_sz=0.5, block_sz=8, chunk=64)
    np.testing.assert_array_equal(f[0], [0.0, 1.0])


def test_candidate_grid_matches_reference():
    c = all_possible_filters(2, nbits=2, step_sz=0.5)
    assert c.shape == (16, 2)
    # values (k + 2 - 2) * 0.5 for k in 0..3 -> {0, .5, 1, 1.5}
    assert set(np.unique(c)) == {0.0, 0.5, 1.0, 1.5}
    # itertools.product order: first tap varies slowest
    np.testing.assert_array_equal(c[0], [0.0, 0.0])
    np.testing.assert_array_equal(c[1], [0.0, 0.5])
    np.testing.assert_array_equal(c[4], [0.5, 0.0])
