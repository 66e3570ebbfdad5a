"""Per-edge Jaccard similarity weights.

JAX-native analogue of ``feature::JaccardWeights`` — the reference's only
GPU kernel (reference: src/sparsebase/feature/jaccard_weights_cuda.cu:
8-150, binary-search warp kernel; host shell jaccard_weights.cc).
Semantics: for every edge (u,v), J = |N(u) ∩ N(v)| / |N(u) ∪ N(v)|,
written to a dense array parallel to the CSR nnz order. The reference
computes each undirected pair once from the lower-degree endpoint and
mirrors the result (jaccard_weights_cuda.cu:117-147); numerically the
output is identical to computing per directed edge, which is what the
vectorized formulation does.

Device path: the same binary-search-per-candidate shape as the CUDA
kernel, vectorized as O(log dmax) rounds of gathered comparisons over a
flat (nnz_expanded,) array — the vectorized version of the reference's
``bst`` loop (jaccard_weights_cuda.cu:70-91), with the ragged edge×degree
expansion linearized by segment offsets instead of padded.
"""

from __future__ import annotations

import numpy as np

from ...formats.array import DenseArray
from ...formats.base import xp_for
from ...formats.csr import CSR
from .base import Feature
from .triangles import _ragged_expand, _searchsorted_segments

MAX_FLAT_EXPANSION = 1 << 25  # Σ deg(u)² slots beyond which the flat
# ragged expansion (int32 ×~5 arrays ≈ 640 MB at 2²⁵) yields to the
# chunked sparse kernel (sparse_common.py)


def _jaccard_host(csr: CSR) -> np.ndarray:
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    n = csr.nrows
    deg = np.diff(indptr)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    v = indices
    # expand: for edge e=(u,v), check every x in N(u) for membership in N(v)
    owner, flat = _ragged_expand(indptr, row)
    cand = indices[flat]  # x in N(u), grouped by edge
    v_of = v[owner]
    lo, hi = indptr[v_of], indptr[v_of + 1]
    pos = lo + _searchsorted_segments(indices, lo, hi, cand)
    found = (pos < hi) & (indices[np.minimum(pos, len(indices) - 1)] == cand)
    inter = np.bincount(owner[found], minlength=csr.nnz)
    union = deg[row] + deg[v] - inter
    return (inter / np.maximum(union, 1)).astype(np.float32)


def _jaccard_device(csr: CSR):
    import jax.numpy as jnp

    from ...utils.exact import ratio_f32

    indptr = csr.indptr.astype(jnp.int32)
    indices = csr.indices.astype(jnp.int32)
    n = csr.nrows
    nnz = csr.nnz
    deg = indptr[1:] - indptr[:-1]
    row = csr.row_of_nnz().astype(jnp.int32)
    # flat ragged expansion: one slot per (edge, candidate) pair
    lens = deg[row]  # per-edge expansion = deg(u)
    total = int(np.asarray(lens.sum()))  # static under eager; = Σ deg(u)²-ish
    starts = jnp.cumsum(lens) - lens
    # owner of each expanded slot via marker scatter + prefix sum
    marks = jnp.zeros((max(total, 1),), jnp.int32).at[starts].add(1, mode="drop")
    owner = (jnp.cumsum(marks) - 1)[:total]
    offs = jnp.arange(total, dtype=jnp.int32) - starts[owner]
    cand = indices[indptr[row[owner]] + offs]
    v_of = indices[owner]
    lo, hi = indptr[v_of], indptr[v_of + 1]
    # vectorized binary search, fixed log2 rounds
    left, right = lo, hi
    max_deg = int(np.asarray(deg.max())) if n else 1
    for _ in range(max(int(np.ceil(np.log2(max(max_deg, 2)))) + 1, 1)):
        mid = (left + right) // 2
        midv = indices[jnp.minimum(mid, nnz - 1)]
        go_right = (left < right) & (midv < cand)
        go_left = (left < right) & ~go_right
        left = jnp.where(go_right, mid + 1, left)
        right = jnp.where(go_left, mid, right)
    found = (left < hi) & (indices[jnp.minimum(left, nnz - 1)] == cand)
    inter = jnp.zeros((nnz,), jnp.int32).at[owner].add(found.astype(jnp.int32))
    union = deg[row] + deg[indices] - inter  # deg(u) + deg(v) - |N(u)∩N(v)|
    return ratio_f32(inter, jnp.maximum(union, 1))


class JaccardWeights(Feature):
    def __init__(self):
        super().__init__("jaccard_weights")
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        csr: CSR = formats[0]
        if xp_for(csr.indptr) is np:
            from ... import native

            if native.available():
                return DenseArray(
                    native.jaccard(
                        csr.nrows,
                        np.asarray(csr.indptr),
                        np.asarray(csr.indices),
                        csr.nnz,
                    )
                )
            return DenseArray(_jaccard_host(csr))
        deg = csr.indptr[1:] - csr.indptr[:-1]
        expansion = int(np.asarray((deg[csr.row_of_nnz()]).sum()))
        if expansion > MAX_FLAT_EXPANSION:
            # big-expansion tier (hubs: Σ deg(u)² slots would not fit):
            # chunked owner-window kernel, numerically identical
            from .sparse_common import jaccard_weights_sparse_device

            return DenseArray(jaccard_weights_sparse_device(csr))
        return DenseArray(_jaccard_device(csr))

    def get_jaccard_weights(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)
