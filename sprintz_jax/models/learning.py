"""Learned filter banks: greedy brute-force forecaster search.

Re-designs the reference's research tooling for choosing FIRE-style
forecaster filter banks (/root/reference/python/learning.py:253-398
``greedy_brute_filters`` + helpers :94-196) as one batched MXU program:

- every candidate filter (all (2^nbits)^ntaps quantized tap vectors) is
  scored in a single (N, ntaps) @ (ntaps, C) matmul per candidate chunk,
- per-block losses (the reference trains on length-``block_sz`` sliding
  windows, stride 1 — a filter must predict whole blocks, like the real
  codec) reduce via a cumulative-sum difference instead of materializing
  (N, B, C) windows,
- the greedy rounds keep only the running best per-position loss
  (N', 1) on device; candidate chunks stream through, so peak memory is
  O(N * chunk) rather than O(N * C).

Semantics match the reference: same candidate grid (values centered at
+1 in steps of ``step_sz``), same greedy objective
mean_i min(best_loss_i, loss_i[c]), same l2/l1/linf losses. This is a
research utility (float math, not byte-exact coding).
"""

from __future__ import annotations

import numpy as np

__all__ = ["all_possible_filters", "greedy_brute_filters"]


def all_possible_filters(ntaps: int, nbits: int = 4, step_sz: float = 0.25
                         ) -> np.ndarray:
    """Every quantized filter: (2^nbits)^ntaps rows of ntaps taps.

    Tap values are ``(k + 1/step_sz - 2^(nbits-1)) * step_sz`` for
    k in [0, 2^nbits) — the reference's grid centered at +1
    (learning.py:94-106).
    """
    assert (1 << nbits) ** ntaps < 100 * 1000, "candidate grid too large"
    nvals = 1 << nbits
    vals = (np.arange(nvals, dtype=np.float32)
            + int(1.0 / step_sz) - (nvals >> 1)) * step_sz
    grids = np.meshgrid(*([vals] * ntaps), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def _block_reduce(losses, block_sz: int, loss: str):
    """Per-sample -> per-sliding-block losses (stride 1, length block_sz;
    learning.py:167-173 windows_as_dim3). l2/l1 are already per-sample
    summables, so the window sum is a cumsum difference; linf is a
    log-step sliding max."""
    import jax.numpy as jnp

    if block_sz <= 1:
        return losses
    n = losses.shape[0]
    if loss == "linf":
        out = losses
        shift = 1
        width = 1
        while width < block_sz:
            step = min(shift, block_sz - width)
            out = jnp.maximum(out[: n - step], out[step:][: n - step])
            n = out.shape[0]
            width += step
            shift *= 2
        return out
    c = jnp.cumsum(losses, axis=0)
    return jnp.concatenate(
        [c[block_sz - 1 : block_sz], c[block_sz:] - c[:-block_sz]], axis=0)


def greedy_brute_filters(
    x: np.ndarray,
    nfilters: int = 4,
    ntaps: int = 4,
    nbits: int = 4,
    step_sz: float = 0.5,
    block_sz: int = -1,
    loss: str = "l2",
    chunk: int = 4096,
    max_samples: int = 1 << 16,
) -> np.ndarray:
    """Greedily pick ``nfilters`` filters minimizing the mean of the
    per-position best loss (reference learning.py:253-398, rebuilt as
    streamed matmuls).

    x: 1-D training signal. Returns (nfilters, ntaps) float32.
    ``chunk``: candidates per device pass (bounds the (N, chunk)
    intermediate). ``max_samples``: training positions are capped by
    subsampling the signal head (a research fit, like the reference's
    small UCR slices).
    """
    import jax
    import jax.numpy as jnp

    assert loss in ("l2", "l1", "linf"), f"unsupported loss {loss!r}"
    block_sz = max(1, block_sz)
    x = np.asarray(x, dtype=np.float32).reshape(-1)[: max_samples + ntaps]
    X = np.stack([x[i : len(x) - ntaps + i] for i in range(ntaps)], axis=1)
    y = x[ntaps:].astype(np.float32)
    X = X[: len(y)]

    cands = all_possible_filters(ntaps, nbits, step_sz)
    C = cands.shape[0]
    npad = (-C) % chunk
    cands_p = np.pad(cands, ((0, npad), (0, 0)))
    cands_j = jnp.asarray(cands_p.reshape(-1, chunk, ntaps))
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y)

    hi = jax.lax.Precision.HIGHEST

    def per_sample(errs):
        return errs * errs if loss == "l2" else jnp.abs(errs)

    @jax.jit
    def chunk_scores(cand_chunk, best):
        """(chunk,) mean of min(best, loss_c) + (n', chunk) block losses'
        argmin bookkeeping — returns per-candidate means only."""
        # f32 at HIGHEST: default precision may run in TF32 on a GPU
        errs = yj[:, None] - jnp.matmul(
            Xj, cand_chunk.T, precision=hi)  # (N, chunk)
        bl = _block_reduce(per_sample(errs), block_sz, loss)
        return jnp.mean(jnp.minimum(bl, best[:, None]), axis=0)

    @jax.jit
    def one_filter_losses(filt):
        errs = yj - jnp.matmul(Xj, filt, precision=hi)
        return _block_reduce(per_sample(errs), block_sz, loss)

    # start from no filters: best loss = loss of predicting zero
    # (reference: errs = y when the filter list is empty, :108-112)
    best = _block_reduce(per_sample(yj), block_sz, loss)

    filters = np.zeros((nfilters, ntaps), dtype=np.float32)
    for i in range(nfilters):
        means = np.concatenate(
            [np.asarray(chunk_scores(cands_j[k], best))
             for k in range(cands_j.shape[0])])[:C]
        bidx = int(np.argmin(means))
        filters[i] = cands[bidx]
        best = jnp.minimum(best, one_filter_losses(jnp.asarray(cands[bidx])))
    return filters
