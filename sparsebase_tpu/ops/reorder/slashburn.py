"""SlashBurn reordering: iterative k-hubset removal + spoke ordering.

JAX-native redesign of ``reorder::SlashburnReorder``
(reference: src/sparsebase/reorder/slashburn_reorder.cc, 424 LoC; params
slashburn_reorder.h:14-23). Layout semantics preserved:

* the graph is symmetrized (A ∪ Aᵀ pattern, slashburn_reorder.cc:330-360)
* non-giant connected components ("spokes") are placed at the **back** of
  the permutation, smallest-first-from-the-end (min-heap over
  (size, root), orderCC placing blocks descending)
* the giant component loops: remove the k highest-degree hubs (placed at
  the **front**, descending degree; ``greedy`` recomputes degrees after
  each removal), re-find components, send non-giant spokes to the back
  (``hub_order`` groups them by discovering hub first), repeat until the
  giant component has < k vertices, which is then placed at the back

Vectorized formulation: degrees are masked scatter-adds, hub selection is
top-k (or k sequential argmax steps when greedy), connected components
are min-label propagation — all O(nnz) array ops instead of the
reference's sequential DFS stacks. Within-spoke order is ascending
vertex id rather than the reference's reversed-BFS visit order; the
hub/spoke block layout (what SlashBurn's quality derives from) is
identical, and validity is gated by permutation/property tests.

Runs on host numpy; device inputs are pulled to host (the reference
similarly runs this preprocessing on CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.csr import CSR
from .base import Reorderer


@dataclasses.dataclass
class SlashburnReorderParams:
    k_size: int = 64
    greedy: bool = True
    hub_order: bool = False


def _symmetrize_pattern(indptr, indices, n):
    """Union of A and Aᵀ patterns, deduplicated."""
    row = np.repeat(np.arange(n, dtype=indices.dtype), np.diff(indptr))
    ur = np.concatenate([row, indices])
    uc = np.concatenate([indices, row])
    keys = ur.astype(np.int64) * n + uc.astype(np.int64)
    uniq = np.unique(keys)
    sr = (uniq // n).astype(indices.dtype)
    sc = (uniq % n).astype(indices.dtype)
    sp = np.concatenate([[0], np.cumsum(np.bincount(sr, minlength=n))]).astype(np.int64)
    return sp, sc


def _cc_labels(indptr, indices, active):
    """Min-label propagation over the active subgraph; inactive = -1."""
    n = active.shape[0]
    labels = np.where(active, np.arange(n, dtype=np.int64), -1)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    live = active[row] & active[indices]
    r, c = row[live], indices[live]
    while True:
        new = labels.copy()
        np.minimum.at(new, c, labels[r])
        np.minimum.at(new, r, labels[c])
        new = np.where(active, new, -1)
        if np.array_equal(new, labels):
            return labels
        labels = new


def _active_degrees(indptr, indices, active):
    row = np.repeat(np.arange(active.shape[0], dtype=np.int64), np.diff(indptr))
    live = active[row] & active[indices]
    return np.bincount(row[live], minlength=active.shape[0])


def _place_spokes(order, labels, active, gcc_label, back_cursor, hub_of=None):
    """Assign back positions to every active non-gcc component.

    Components sorted ascending by (hub index, size, min label) take the
    highest remaining positions first (the reference's min-heap + orderCC
    placement). Returns (new back_cursor, updated active)."""
    spoke_mask = active & (labels != gcc_label) & (labels >= 0)
    if not spoke_mask.any():
        return back_cursor, active
    verts = np.nonzero(spoke_mask)[0]
    comp = labels[verts]
    uniq, inv = np.unique(comp, return_inverse=True)
    sizes = np.bincount(inv)
    hub_key = np.zeros(len(uniq), np.int64)
    if hub_of is not None:
        hub_key = np.full(len(uniq), np.iinfo(np.int64).max)
        np.minimum.at(hub_key, inv, hub_of[verts])
    comp_order = np.lexsort((uniq, sizes, hub_key))  # ascending
    # component processed first gets the end-most block
    rank_of_comp = np.zeros(len(uniq), np.int64)
    rank_of_comp[comp_order] = np.arange(len(uniq))
    ordered_sizes = sizes[comp_order]
    # block end position for processing-rank r: back_cursor - sum(sizes of ranks < r)
    ends = back_cursor - np.concatenate([[0], np.cumsum(ordered_sizes)[:-1]])
    starts = ends - ordered_sizes + 1
    # within component: ascending id forward from block start
    order_in_comp = np.zeros(verts.shape[0], np.int64)
    sort_key = np.lexsort((verts, rank_of_comp[inv]))
    seq = verts[sort_key]
    comp_rank_seq = rank_of_comp[inv][sort_key]
    offsets = np.arange(seq.shape[0]) - np.searchsorted(
        comp_rank_seq, comp_rank_seq, side="left"
    )
    order[seq] = starts[comp_rank_seq] + offsets
    active = active & ~spoke_mask
    return back_cursor - int(ordered_sizes.sum()), active


def _slashburn_host(csr: CSR, params: SlashburnReorderParams):
    n = csr.nrows
    k = max(int(params.k_size), 1)
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    sp, sc = _symmetrize_pattern(indptr, indices, n)

    order = np.full(n, -1, np.int64)
    active = np.ones(n, bool)
    front = 0
    back = n - 1

    # initial spokes: everything outside the giant component
    labels = _cc_labels(sp, sc, active)
    sizes = np.bincount(labels[labels >= 0], minlength=n)
    gcc = int(np.argmax(sizes))
    back, active = _place_spokes(order, labels, active, gcc, back)

    while True:
        count = int(active.sum())
        if count == 0:
            break
        if count < k:
            # remaining giant component goes to the back, ascending id
            verts = np.nonzero(active)[0]
            order[verts] = back - count + 1 + np.arange(count)
            back -= count
            break
        degrees = _active_degrees(sp, sc, active)
        degrees = np.where(active, degrees, -1)
        hub_of = np.full(n, np.iinfo(np.int64).max, np.int64)
        if params.greedy:
            hubs = np.empty(k, np.int64)
            for i in range(k):
                h = int(np.argmax(degrees))
                hubs[i] = h
                degrees[h] = -1
                nbrs = sc[sp[h] : sp[h + 1]]
                degrees[nbrs[active[nbrs] & (degrees[nbrs] > 0)]] -= 1
                active[h] = False
        else:
            # deterministic: descending degree, ascending id within ties
            hubs = np.lexsort((np.arange(n), -degrees))[:k]
            active[hubs] = False
        order[hubs] = front + np.arange(k)
        front += k
        if params.hub_order:
            for i, h in enumerate(hubs):
                nbrs = sc[sp[h] : sp[h + 1]]
                hub_of[nbrs] = np.minimum(hub_of[nbrs], i)
        labels = _cc_labels(sp, sc, active)
        live = labels[labels >= 0]
        if live.size == 0:
            break
        sizes = np.bincount(live, minlength=n)
        gcc = int(np.argmax(sizes))
        back, active = _place_spokes(
            order, labels, active, gcc, back, hub_of if params.hub_order else None
        )
        if int(sizes[gcc]) < k:
            verts = np.nonzero(active)[0]
            order[verts] = back - verts.size + 1 + np.arange(verts.size)
            back -= verts.size
            break
    return order.astype(np.asarray(csr.indices).dtype)


def _slashburn_impl(formats, params: SlashburnReorderParams):
    csr: CSR = formats[0].to_host()
    from ... import native

    if native.available():
        out = native.slashburn(
            csr.nrows,
            np.asarray(csr.indptr),
            np.asarray(csr.indices),
            max(int(params.k_size), 1),
            params.greedy,
            params.hub_order,
        )
        return out.astype(np.asarray(csr.indices).dtype)
    return _slashburn_host(csr, params)


class SlashburnReorder(Reorderer):
    def __init__(self, k_size: int = 64, greedy: bool = True, hub_order: bool = False):
        super().__init__("slashburn_reorder")
        self.params = SlashburnReorderParams(k_size, greedy, hub_order)
        self.register((CSR,), _slashburn_impl)
