"""Nested-dissection fill-reducing ordering (METIS_NodeND-equivalent).

JAX-native analogue of ``reorder::MetisReorder``
(reference: src/sparsebase/reorder/metis_reorder.cc:26-60, wrapping
external ``METIS_NodeND``; params metis_reorder.h:15). Native scheme:

* recursively 2-way partition the graph (the multilevel bisection from
  ops/partition/multilevel.py)
* derive a vertex separator from the cut boundary (the smaller boundary
  side — a cheap vertex cover of the cut edges)
* order = [left block, right block, separator], recursing into the
  blocks; small blocks fall through to minimum-degree (ops/reorder/amd)

Returns an inverse permutation like every reorderer. Quality gate:
profile/fill reduction tolerance (BASELINE.md), not identical orders.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.csr import CSR
from .base import Reorderer


@dataclasses.dataclass
class MetisReorderParams:
    ctype: str = "shem"
    rtype: str = "sep1sided"
    nseps: int = 1
    niter: int = 10
    seed: int = 42
    ufactor: int = 30
    pfactor: int = 0
    compress: int = 1
    leaf_size: int = 64


def _subgraph(indptr, indices, vertices, n):
    sub_id = np.full(n, -1, np.int64)
    sub_id[vertices] = np.arange(len(vertices))
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    mask = (sub_id[row] >= 0) & (sub_id[indices] >= 0)
    sr, sc = sub_id[row[mask]], sub_id[indices[mask]]
    order = np.argsort(sr, kind="stable")
    sip = np.concatenate(
        [[0], np.cumsum(np.bincount(sr, minlength=len(vertices)))]
    ).astype(np.int64)
    return sip, sc[order]


def _min_degree_block(sip, six, m):
    """Order a small block by repeated min-degree (exact, tiny n). Large
    degenerate blocks (the exact algorithm is superquadratic under fill)
    fall back to an ascending-degree sort."""
    if m > 2000:
        return np.argsort(np.diff(sip), kind="stable")
    from .amd import _min_degree_order

    return _min_degree_order(sip, six, m, np.inf)


def _nested_dissection(indptr, indices, n, params: MetisReorderParams):
    from ...ops.partition.multilevel import (
        MetisPartitionParams,
        _refine,
        _region_grow,
        _symmetrize,
        multilevel_partition,
    )

    rng = np.random.default_rng(params.seed)
    result = np.empty(n, dtype=np.int64)  # result[pos] = vertex (perm)
    cursor = [0]

    def emit(vertices):
        result[cursor[0] : cursor[0] + len(vertices)] = vertices
        cursor[0] += len(vertices)

    def recurse(vertices):
        m = len(vertices)
        if m == 0:
            return
        if m <= params.leaf_size:
            sip, six = _subgraph(indptr, indices, vertices, n)
            local = _min_degree_block(sip, six, m)
            emit(vertices[local])
            return
        sip, six = _subgraph(indptr, indices, vertices, n)
        ew = np.ones(len(six), np.float64)
        vw = np.ones(m, np.float64)
        cap = (1.0 + params.ufactor / 1000.0) * m / 2
        two = _region_grow(sip, six, ew, vw, 2, rng, cap)
        two = _refine(sip, six, ew, vw, two, 2, cap, rounds=params.niter)
        # boundary vertices per side
        row = np.repeat(np.arange(m, dtype=np.int64), np.diff(sip))
        cutmask = two[row] != two[six]
        b0 = np.unique(row[cutmask & (two[row] == 0)])
        b1 = np.unique(row[cutmask & (two[row] == 1)])
        sep_local = b0 if len(b0) <= len(b1) else b1
        sep_set = np.zeros(m, bool)
        sep_set[sep_local] = True
        left = vertices[(two == 0) & ~sep_set]
        right = vertices[(two == 1) & ~sep_set]
        sep = vertices[sep_set]
        if len(left) == 0 or len(right) == 0:
            # bisection degenerated: fall back to min-degree on the block
            local = _min_degree_block(sip, six, m)
            emit(vertices[local])
            return
        recurse(left)
        recurse(right)
        emit(sep)

    recurse(np.arange(n, dtype=np.int64))
    inv = np.empty(n, dtype=np.int64)
    inv[result] = np.arange(n)
    return inv


def _metis_reorder_impl(formats, params: MetisReorderParams):
    csr: CSR = formats[0].to_host()
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    from ... import native

    if native.available():
        return native.nested_dissection(
            csr.nrows,
            indptr,
            indices,
            params.seed,
            params.ufactor,
            params.niter,
            params.leaf_size,
        ).astype(np.asarray(csr.indices).dtype)
    # symmetrize pattern for dissection
    from ...ops.partition.multilevel import _symmetrize

    ew = np.ones(csr.nnz, np.float64)
    sip, six, _ = _symmetrize(indptr, indices, ew, csr.nrows)
    inv = _nested_dissection(sip, six, csr.nrows, params)
    return inv.astype(np.asarray(csr.indices).dtype)


class MetisReorder(Reorderer):
    """Native nested-dissection reorderer (METIS_NodeND-equivalent API)."""

    def __init__(self, **kw):
        super().__init__("metis_reorder")
        self.params = MetisReorderParams(**kw)
        self.register((CSR,), _metis_reorder_impl)
