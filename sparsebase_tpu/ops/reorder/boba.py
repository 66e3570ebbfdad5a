"""BOBA reordering ("Batched Order By Attachment").

JAX-native analogue of ``reorder::BOBAReorder``
(reference: src/sparsebase/reorder/boba_reorder.cc:33-160; params
boba_reorder.h:13-18). Reference semantics: sort COO entries by
(col, row); emit vertices by first appearance in the sequence
``rows_of_sorted ++ cols_of_sorted``; isolated vertices follow in id
order. The reference's sequential and OpenMP variants compute the same
ordering (the parallel one ranks by minimum appearance index, ties by
id) — here one scatter-min + one sort covers both, so ``sequential``
is accepted for parity but has no effect.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.base import xp_for
from ...formats.coo import COO
from .base import Reorderer, ranks_from_sort_keys


@dataclasses.dataclass
class BOBAReorderParams:
    sequential: bool = False


def _boba_impl(formats, params: BOBAReorderParams):
    coo: COO = formats[0]
    xp = xp_for(coo.row, coo.col)
    nnz = coo.nnz
    n = max(coo.nrows, coo.ncols)
    # sort entries by (col, row) — boba_reorder.cc:64-67
    order1 = xp.argsort(coo.row, stable=True)
    order2 = xp.argsort(coo.col[order1], stable=True)
    e = order1[order2]
    seq = xp.concatenate([coo.row[e], coo.col[e]])  # appearance sequence
    INF = 2 * nnz + n
    first = xp.full((n,), INF, dtype=xp.int64)
    idx = xp.arange(2 * nnz, dtype=xp.int64)
    if xp is np:
        np.minimum.at(first, seq, idx)
    else:
        first = first.at[seq].min(idx)
    # rank by (first appearance, id); isolated (INF) sink to the end in id
    # order. Two-key lexsort — no wide fused keys (int64 is unavailable on
    # device without x64).
    ids = xp.arange(n)
    perm = xp.lexsort((ids, first))  # perm[new] = old
    inv = xp.zeros((n,), dtype=coo.row.dtype)
    if xp is np:
        inv[perm] = np.arange(n, dtype=inv.dtype)
    else:
        inv = inv.at[perm].set(xp.arange(n, dtype=inv.dtype))
    return inv


class BOBAReorder(Reorderer):
    def __init__(self, sequential: bool = False):
        super().__init__("boba_reorder")
        self.params = BOBAReorderParams(sequential)
        self.register((COO,), _boba_impl)
