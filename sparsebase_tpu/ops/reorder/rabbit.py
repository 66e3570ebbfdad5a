"""Rabbit-order-style community/locality clustering reordering.

JAX-native analogue of ``reorder::RabbitReorder``
(reference: src/sparsebase/reorder/rabbit_reorder.cc:25-50, wrapping the
vendored rabbit_order library's ``aggregate`` + ``compute_perm``).
Native scheme following the same structure (community aggregation into a
merge dendrogram, then ordering by dendrogram traversal):

* single incremental pass over vertices in ascending-degree order: each
  vertex merges into the adjacent community with maximum modularity gain
  ΔQ = w(v,c)/W − deg(v)·deg(c)/(2W²) when positive (rabbit-order's
  aggregation rule)
* the merge forest is traversed depth-first; leaves receive consecutive
  new ids, giving the locality-preserving permutation
  (``compute_perm`` analogue)

Host-side (union-find aggregation is sequential); device inputs are
pulled to host.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from ...formats.csr import CSR
from .base import Reorderer


@dataclasses.dataclass
class RabbitReorderParams:
    """The reference rabbit reorder takes no parameters."""


def _rabbit_impl(formats, params):
    csr: CSR = formats[0].to_host()
    n = csr.nrows
    from ... import native

    if native.available():
        out = native.rabbit(n, np.asarray(csr.indptr), np.asarray(csr.indices))
        return out.astype(np.asarray(csr.indices).dtype)
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    # symmetrized weighted adjacency as dict-of-dicts at community level
    W = max(len(row), 1)
    # union-find with merge children (dendrogram forest)
    parent = np.arange(n, dtype=np.int64)
    children = defaultdict(list)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # community adjacency and degree
    com_adj = [defaultdict(float) for _ in range(n)]
    for u, v in zip(row.tolist(), indices.tolist()):
        if u != v:
            com_adj[u][v] += 1.0
    com_deg = np.array([sum(a.values()) for a in com_adj])

    order_by_deg = np.argsort(np.diff(indptr), kind="stable")
    for v in order_by_deg.tolist():
        rv = find(v)
        if rv != v:
            continue  # already merged into a community
        adj = com_adj[rv]
        if not adj:
            continue
        best_gain, best_c = 0.0, -1
        deg_v = com_deg[rv]
        for u, w in list(adj.items()):
            ru = find(u)
            if ru == rv:
                continue
            gain = w / W - (deg_v * com_deg[ru]) / (2.0 * W * W)
            if gain > best_gain:
                best_gain, best_c = gain, ru
        if best_c >= 0:
            # merge v's community into best_c
            parent[rv] = best_c
            children[best_c].append(rv)
            tgt = com_adj[best_c]
            for u, w in adj.items():
                ru = find(u)
                if ru != best_c:
                    tgt[ru] += w
            com_adj[rv] = defaultdict(float)
            com_deg[best_c] += deg_v

    # DFS over the merge forest: roots in ascending id, children in merge
    # order, leaves get consecutive new ids (compute_perm analogue)
    inv = np.empty(n, dtype=np.asarray(csr.indices).dtype)
    counter = 0
    visited = np.zeros(n, bool)
    for root in range(n):
        if find(root) != root or visited[root]:
            continue
        stack = [root]
        while stack:
            x = stack.pop()
            if visited[x]:
                continue
            visited[x] = True
            inv[x] = counter
            counter += 1
            stack.extend(reversed(children[x]))
    return inv


class RabbitReorder(Reorderer):
    def __init__(self, params: RabbitReorderParams | None = None):
        super().__init__("rabbit_reorder")
        self.params = params or RabbitReorderParams()
        self.register((CSR,), _rabbit_impl)
