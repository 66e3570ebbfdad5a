"""Triangle counting.

JAX-native analogue of ``feature::TriangleCount``
(reference: src/sparsebase/feature/triangle_count.cc; params
triangle_count.h:12-16 {countDirected}). Reference semantics:

* undirected (UndirectedTriangleCount, :177-205): count triples
  u < v < w with edges (u,v), (v,w), (u,w) present — each triangle once
  (assumes a symmetric adjacency).
* directed (DirectedTriangleCount, :141-175): count directed 3-cycles
  u → v → w → u, anchored at their minimum vertex.

Formulation: the reference's sequential hash-marker loops become a
vectorized sorted-adjacency intersection — for each qualifying edge
(v,w) the count of common filtered neighbors is found by binary search
(`searchsorted`) of one adjacency list in the other, a flat ragged
expansion on host and the static-shape padded form on device (the same
shape as the reference's GPU Jaccard kernel, jaccard_weights_cuda.cu).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.base import xp_for
from ...formats.csr import CSR
from .base import Feature


@dataclasses.dataclass
class TriangleCountParams:
    count_directed: bool = False


def _ragged_expand(indptr, sources):
    """(edge-of-source index, flat target positions) for rows `sources`."""
    starts = indptr[sources]
    lens = indptr[sources + 1] - starts
    total = int(lens.sum())
    owner = np.repeat(np.arange(len(sources)), lens)
    offs = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    return owner, np.repeat(starts, lens) + offs


def _count_common_sorted(indptr, indices, a_verts, b_verts):
    """For each pair (a, b): |N(a) ∩ N(b)| using binary search of each
    element of N(a) in sorted N(b). Vectorized over all pairs (host)."""
    owner, flat = _ragged_expand(indptr, a_verts)
    cand = indices[flat]  # elements of N(a), grouped by pair index
    b_of = b_verts[owner]
    lo = indptr[b_of]
    hi = indptr[b_of + 1]
    # binary search cand in indices[lo:hi] per element
    pos = lo + _searchsorted_segments(indices, lo, hi, cand)
    found = (pos < hi) & (indices[np.minimum(pos, len(indices) - 1)] == cand)
    return np.bincount(owner[found], minlength=len(a_verts))


def _searchsorted_segments(indices, lo, hi, targets):
    """Vectorized per-segment lower_bound via global searchsorted trick:
    segments of a CSR indices array are sorted, so searchsorted within
    [lo,hi) = manual binary search vectorized over rounds."""
    n = targets.shape[0]
    left = lo.copy()
    right = hi.copy()
    # classic vectorized binary search: O(log max_deg) rounds
    while True:
        active = left < right
        if not active.any():
            break
        mid = (left + right) // 2
        midv = indices[np.minimum(mid, len(indices) - 1)]
        go_right = active & (midv < targets)
        left = np.where(go_right, mid + 1, left)
        right = np.where(active & ~go_right, mid, right)
    return left - lo


def _dedup_adj(indptr, indices, n):
    """Set-semantics adjacency: unique (row, col) pairs. All triangle
    paths in this package (host, native, device matmul, ring) count each
    distinct edge once — the reference's marker check dedups the closing
    edge but *iterates* the first two adjacency lists, so duplicated
    input entries multiply its count (triangle_count.cc:190-203); its
    tests only feed simple graphs, and set semantics is the documented
    behavior here (README fidelity note)."""
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keys = np.unique(row * n + indices)
    r = keys // n
    c = keys % n
    ip = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return ip.astype(np.int64), c.astype(np.int64)


def _undirected_count(csr: CSR) -> int:
    n = csr.nrows
    indptr, indices = _dedup_adj(
        np.asarray(csr.indptr).astype(np.int64),
        np.asarray(csr.indices).astype(np.int64),
        n,
    )
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    # edges (v,w) with v<w; for each, count u in N(v)∩N(w) with u<v:
    # equivalently common neighbors of v,w then filter by u<v via counting
    # over the filtered "predecessor" graph L: u -> {x : x>u}
    mask = indices > row  # successor edges
    lv, lw = row[mask], indices[mask]
    # build successor CSR S: S[u] = sorted {x>u}
    s_counts = np.bincount(row[mask], minlength=n)
    s_indptr = np.concatenate([[0], np.cumsum(s_counts)])
    s_indices = indices[mask]  # already grouped by row, sorted within row
    # count |S(v) ∩ S(w)| for each successor edge (v,w): triangles v<w, x>v, x>w...
    # Triple u<v<w needs edges (u,v),(u,w),(v,w): for edge (v,w): common
    # *predecessors* u. Predecessor graph = transpose of S. Use P = CSC of S.
    p_counts = np.bincount(s_indices, minlength=n)
    p_indptr = np.concatenate([[0], np.cumsum(p_counts)])
    order = np.argsort(s_indices, kind="stable")
    p_row = np.repeat(np.arange(n, dtype=np.int64), s_counts)
    p_indices = p_row[order]  # predecessors, sorted within each target
    counts = _count_common_sorted(p_indptr, p_indices, lv, lw)
    return int(counts.sum())


def _directed_count(csr: CSR) -> int:
    """Directed 3-cycles u→v→w→u anchored at min vertex u
    (DirectedTriangleCount parity; set semantics — see _dedup_adj)."""
    n = csr.nrows
    indptr, indices = _dedup_adj(
        np.asarray(csr.indptr).astype(np.int64),
        np.asarray(csr.indices).astype(np.int64),
        n,
    )
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    count = 0
    # edges u->v with u<v; for each, count w in N(v) with w>u and w->u
    mask = indices > row
    eu, ev = row[mask], indices[mask]
    owner, flat = _ragged_expand(indptr, ev)
    w = indices[flat]
    u_of = eu[owner]
    ok = w > u_of
    # membership test: w -> u edge exists?
    lo = indptr[w]
    hi = indptr[w + 1]
    pos = lo + _searchsorted_segments(indices, lo, hi, u_of)
    found = (pos < hi) & (indices[np.minimum(pos, len(indices) - 1)] == u_of)
    return int((ok & found).sum())


MAX_DEVICE_DENSE_N = 16384  # n² bf16 tile ≤ 512 MB


def _device_dense_count(csr: CSR, directed: bool) -> int:
    """Dense path: triangles as entries of A² — T = Σ A⊙A² / 6 (undirected,
    symmetric A) or Σ Aᵀ⊙A² / 3 (directed 3-cycles). 0/1 bf16 operands
    with exact f32 accumulation (per-entry counts ≤ n < 2²⁴); the
    diagonal is zeroed so self-loops are ignored, matching the host
    path. The *global* reduction is recovered exactly via the
    wrapped-int32 + f32 pair (``utils.exact``): a plain f32 sum drifts
    once 6T > 2²⁴ (~2.8M triangles). Same formulation as the
    distributed ring kernel (parallel/ring.py) on one chip."""
    import jax
    import jax.numpy as jnp

    from ...utils.exact import combine_wrapped

    n = csr.nrows
    lrow = csr.row_of_nnz().astype(jnp.int32)
    one = jnp.ones((csr.nnz,), jnp.bfloat16)
    dense = jnp.zeros((n, n), jnp.bfloat16).at[lrow, csr.indices].max(one, mode="drop")
    dense = jnp.where(jnp.eye(n, dtype=bool), jnp.bfloat16(0), dense)
    sq = jnp.dot(dense, dense, preferred_element_type=jnp.float32)
    mask = dense.T if directed else dense
    prod = sq * mask.astype(jnp.float32)  # exact integers ≤ n < 2³¹
    wrapped = jnp.sum(prod.astype(jnp.int32))  # exact mod 2³²
    approx = jnp.sum(prod)
    total = combine_wrapped(
        int(np.asarray(jax.device_get(wrapped))),
        float(np.asarray(jax.device_get(approx))),
    )
    return total // (3 if directed else 6)


class TriangleCount(Feature):
    def __init__(self, count_directed: bool = False):
        super().__init__("triangle_count")
        self.params = TriangleCountParams(count_directed)
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params: TriangleCountParams):
        if xp_for(formats[0].indptr) is not np:
            if formats[0].nrows <= MAX_DEVICE_DENSE_N:
                return _device_dense_count(formats[0], params.count_directed)
            if not params.count_directed:
                # big-n tier: chunked owner-window kernel, no densification
                # (single-chip port of the sparse ring)
                from .sparse_common import triangle_count_sparse_device

                return triangle_count_sparse_device(formats[0])
        csr: CSR = formats[0].to_host()
        from ... import native

        if native.available():
            return native.triangles(
                csr.nrows,
                np.asarray(csr.indptr),
                np.asarray(csr.indices),
                params.count_directed,
            )
        if params.count_directed:
            return _directed_count(csr)
        return _undirected_count(csr)

    def get_triangle_count(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)
