"""Reorder heatmap: b×b block-density of a (re)ordered matrix.

JAX-native analogue of ``reorder::ReorderHeatmap``
(reference: src/sparsebase/reorder/reorder_heatmap.cc:42-120; params
ReorderHeatmapParams{num_parts}). A three-input op (CSR + row perm array
+ col perm array, both inverse permutations). Density[bu, bv] = count of
entries mapping into block (bu, bv) divided by nnz, with
``bsize = n // b`` and block clipped to b-1 — identical binning to the
reference (reorder_heatmap.cc:62-87). The scalar double loop becomes a
single scatter-add histogram.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...dispatch import Operation
from ...formats.array import DenseArray
from ...formats.base import xp_for
from ...formats.csr import CSR
from ...utils.exceptions import ReorderError


@dataclasses.dataclass
class ReorderHeatmapParams:
    num_parts: int = 8


def _heatmap_pass(formats, params: ReorderHeatmapParams):
    """One fused pass: block-density histogram + bandwidth stats, the
    reference's single loop (reorder_heatmap.cc:70-106) vectorized."""
    csr: CSR = formats[0]
    order_r: DenseArray = formats[1]
    order_c: DenseArray = formats[2]
    b = int(params.num_parts)
    n, m = csr.shape
    if b > n or b > m:
        raise ReorderError(
            "Cannot generate heatmap for matrix when num_parts > number of rows or columns"
        )
    xp = xp_for(csr.indptr, csr.indices)
    row = csr.row_of_nnz()
    u = order_r.vals[row]
    v = order_c.vals[csr.indices]
    bsize = n // b
    bu = xp.minimum(u // bsize, b - 1).astype(xp.int64)
    bv = xp.minimum(v // bsize, b - 1).astype(xp.int64)
    flat = bu * b + bv
    bw = xp.abs(u.astype(xp.int64) - v.astype(xp.int64))
    if xp is np:
        counts = np.bincount(flat, minlength=b * b)[: b * b]
    else:
        import jax.numpy as jnp

        counts = jnp.bincount(flat, length=b * b)
    nnz = max(csr.nnz, 1)
    heat = counts.astype(xp.float32) / nnz
    # fused bandwidth stats (reorder_heatmap.cc:58-59,76-85,91-106)
    grid = counts.reshape(b, b)
    bi = xp.arange(b)
    block_bw_sum = xp.sum(xp.abs(bi[:, None] - bi[None, :]) * grid)
    stats = {
        "mean_bw": float(xp.sum(bw.astype(xp.float32))) / nnz,
        "max_bw": int(xp.max(bw)) if bw.shape[0] else 0,
        "num_full_blocks": int(xp.sum(grid > 0)),
        "block_mean_bw": float(block_bw_sum) / nnz,
    }
    return DenseArray(heat), stats


def _heatmap_impl(formats, params: ReorderHeatmapParams):
    heat, _ = _heatmap_pass(formats, params)
    return heat


class ReorderHeatmap(Operation):
    def __init__(self, num_parts: int = 8):
        super().__init__("reorder_heatmap")
        self.params = ReorderHeatmapParams(num_parts)
        self.register((CSR, DenseArray, DenseArray), _heatmap_impl)
        self._stats_op = Operation("reorder_heatmap_stats")
        self._stats_op.register((CSR, DenseArray, DenseArray), _heatmap_pass)

    def get_heatmap(self, fmt, order_r: DenseArray, order_c: DenseArray, context=None):
        return self.execute(self.params, fmt, order_r, order_c, context=context)

    def get_heatmap_with_stats(
        self, fmt, order_r: DenseArray, order_c: DenseArray, context=None
    ):
        """(heatmap, stats) in one fused pass — the reference computes
        mean/max bandwidth, full-block count and block bandwidth alongside
        the density grid (reorder_heatmap.cc:58-59,76-106); stats keys:
        ``mean_bw``, ``max_bw``, ``num_full_blocks``, ``block_mean_bw``."""
        return self._stats_op.execute(
            self.params, fmt, order_r, order_c, context=context
        )
