"""Approximate/exact minimum-degree fill-reducing ordering (AMD-equivalent).

JAX-native analogue of ``reorder::AMDReorder``
(reference: src/sparsebase/reorder/amd_reorder.cc:29-57, wrapping
SuiteSparse ``amd_l_order``; params amd_reorder.h:27 {dense,
aggressive}). The reference converts to <long,long> CSR, calls the
external solver, and maps the permutation back; here the minimum-degree
elimination runs natively on a **quotient graph** with element
absorption and a lazy min-heap (degrees recomputed on pop), the same
structure AMD builds — but with exact external degrees instead of
AMD's upper-bound approximation, trading a constant factor of time for
slightly better orderings.

``dense`` (like AMD_DENSE): rows with degree > dense·√n are ordered
last. ``aggressive`` mirrors AMD's aggressive-absorption switch
(amd_reorder.h:27 → AMD_AGGRESSIVE): when on, an element whose variable
list is contained in the new pivot element's list is absorbed even if
it was not adjacent to the pivot; when off only standard absorption of
the pivot's own elements runs. Both the native kernel and this fallback
thread the flag through; orderings can differ between the modes through
degree-bound/tie-break divergence (regression-tested).

Sequential by nature (SURVEY.md §7 hard part 2): runs host-side; device
inputs are pulled to host. Acceptance is fill/profile tolerance, not
exact order equality.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ...formats.csr import CSR
from .base import Reorderer


@dataclasses.dataclass
class AMDReorderParams:
    dense: float = 10.0  # AMD_DEFAULT_DENSE
    aggressive: bool = True


def _min_degree_order(indptr, indices, n, dense_threshold, aggressive=True):
    """Quotient-graph minimum-degree elimination. Returns elimination
    order as perm[new] = old. ``aggressive`` additionally absorbs
    elements whose (live) variable lists are contained in the new
    element's list (AMD aggressive absorption)."""
    # adjacency sets (symmetrized, no self loops)
    A = [set() for _ in range(n)]
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for u, v in zip(row.tolist(), indices.tolist()):
        if u != v:
            A[u].add(v)
            A[v].add(u)
    E = [set() for _ in range(n)]  # elements adjacent to each variable
    L = {}  # element -> variable set
    eliminated = np.zeros(n, bool)
    dense_mask = np.array([len(A[v]) for v in range(n)]) > dense_threshold
    heap = []
    for v in range(n):
        if not dense_mask[v]:
            heapq.heappush(heap, (len(A[v]), v))
    perm = []
    next_element = n  # element ids start after variables

    def current_degree(v):
        nbrs = set(A[v])
        for e in E[v]:
            if e in L:
                nbrs |= L[e]
        nbrs.discard(v)
        return len([u for u in nbrs if not eliminated[u]]), nbrs

    count = int((~dense_mask).sum())
    while len(perm) < count:
        d, v = heapq.heappop(heap)
        if eliminated[v] or dense_mask[v]:
            continue
        true_d, nbrs = current_degree(v)
        if true_d > d:
            heapq.heappush(heap, (true_d, v))
            continue
        # eliminate v
        eliminated[v] = True
        perm.append(v)
        Lv = {u for u in nbrs if not eliminated[u]}
        if Lv:
            e_new = next_element
            next_element += 1
            L[e_new] = Lv
            absorbed = set()
            for u in Lv:
                A[u].discard(v)
                A[u] -= Lv  # edges inside the clique are covered by e_new
                # absorb v's elements (their variables are in L[e_new])
                for e in E[v]:
                    if e in E[u]:
                        E[u].discard(e)
                        absorbed.add(e)
                E[u].add(e_new)
                heapq.heappush(heap, (max(len(A[u]) + sum(1 for e in E[u] if e in L) - 1, 0), u))
            for e in E[v]:
                L.pop(e, None)
            if aggressive:
                # aggressive absorption: any live element adjacent to the
                # clique whose live members all sit inside Lv is covered
                # by e_new — drop it (E lists are pruned lazily via
                # ``e in L`` checks).
                cand = set()
                for u in Lv:
                    cand |= {e for e in E[u] if e in L and e != e_new}
                for e in cand:
                    live = {x for x in L[e] if not eliminated[x]}
                    if live <= Lv:
                        L.pop(e, None)
        else:
            for e in E[v]:
                L.pop(e, None)
        A[v] = set()
        E[v] = set()
    # dense rows last, ascending id (AMD's dense-row handling)
    perm.extend(np.nonzero(dense_mask)[0].tolist())
    return np.array(perm, dtype=np.int64)


def _amd_impl(formats, params: AMDReorderParams):
    csr: CSR = formats[0].to_host()
    n = csr.nrows
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    thr = params.dense * np.sqrt(max(n, 1)) if params.dense > 0 else np.inf
    from ... import native

    if native.available():
        return native.amd(n, indptr, indices, thr, params.aggressive).astype(
            np.asarray(csr.indices).dtype
        )
    perm = _min_degree_order(
        indptr, indices, n, thr, aggressive=params.aggressive
    )  # perm[new] = old
    inv = np.empty(n, dtype=np.asarray(csr.indices).dtype)
    inv[perm] = np.arange(n, dtype=inv.dtype)
    return inv


class AMDReorder(Reorderer):
    def __init__(self, dense: float = 10.0, aggressive: bool = True):
        super().__init__("amd_reorder")
        self.params = AMDReorderParams(dense, aggressive)
        self.register((CSR,), _amd_impl)
