"""Size-constrained label-propagation partitioning (PULP-equivalent).

JAX-native analogue of ``partition::PulpPartition``
(reference: src/sparsebase/partition/pulp_partition.cc:30-69 wrapping the
external PULP solver; params pulp_partition.h). PULP's core is
degree-weighted label propagation under vertex/edge balance constraints
— implemented here natively as vectorized rounds:

1. init: balanced BFS seeding (``do_bfs_init``) or contiguous chunks
   (``do_lp_init``)
2. propagation: each vertex scores every part by its (optionally
   edge-weighted) neighbor count minus an over-capacity penalty; all
   vertices move simultaneously to their argmax part
3. balance fixup: oversized parts evict their lowest-gain boundary
   vertices to the best under-capacity part

Every step is an O(nnz) scatter-add + an O(n·k) argmax — both map
directly onto vectorized device ops, and run under jit (static shapes) or in numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.base import xp_for
from ...formats.csr import CSR
from .base import Partitioner


@dataclasses.dataclass
class PulpPartitionParams:
    """Mirrors PulpPartitionParams (pulp_partition.h)."""

    num_partitions: int = 2
    vert_balance: float = 1.1
    edge_balance: float = 1.5
    do_lp_init: bool = False
    do_bfs_init: bool = True
    do_repart: bool = False
    do_edge_balance: bool = False
    do_maxcut_balance: bool = False
    seed: int = 42
    num_iterations: int = 20


def _bfs_seed(xp, csr: CSR, k: int, seed: int):
    """Multi-source BFS from k spread-out seeds; unreached → nearest chunk."""
    n = csr.nrows
    rng = np.random.default_rng(seed)
    seeds = rng.choice(n, size=min(k, n), replace=False)
    labels = xp.full((n,), -1, dtype=xp.int32)
    if xp is np:
        labels[seeds] = np.arange(len(seeds), dtype=np.int32)
    else:
        labels = labels.at[xp.asarray(seeds)].set(xp.arange(len(seeds), dtype=xp.int32))
    row = csr.row_of_nnz()
    for _ in range(64):
        unassigned = labels < 0
        src = labels[row]
        prop = xp.full((n,), 2**30, dtype=xp.int32)
        cand = xp.where(src >= 0, src, 2**30)
        if xp is np:
            np.minimum.at(prop, csr.indices, cand)
        else:
            prop = prop.at[csr.indices].min(cand)
        new = xp.where(unassigned & (prop < 2**30), prop, labels)
        if xp is np and np.array_equal(new, labels):
            labels = new
            break
        labels = new
    # any still unreached: contiguous chunks
    chunk = (xp.arange(n, dtype=xp.int32) * k) // max(n, 1)
    return xp.where(labels < 0, chunk, labels)


def _neighbor_counts(xp, csr: CSR, labels, k: int, weights=None):
    """(n, k) matrix of neighbor-label counts."""
    row = csr.row_of_nnz()
    w = weights if weights is not None else 1
    if xp is np:
        out = np.zeros((csr.nrows, k), dtype=np.float32)
        vals = np.ones(csr.nnz, np.float32) if weights is None else weights.astype(np.float32)
        np.add.at(out, (row, labels[csr.indices]), vals)
        return out
    import jax.numpy as jnp

    vals = (
        jnp.ones((csr.nnz,), jnp.float32)
        if weights is None
        else weights.astype(jnp.float32)
    )
    return jnp.zeros((csr.nrows, k), jnp.float32).at[row, labels[csr.indices]].add(vals)


def label_prop_partition(csr: CSR, params: PulpPartitionParams):
    xp = xp_for(csr.indptr, csr.indices)
    n = csr.nrows
    k = int(params.num_partitions)
    if k <= 1:
        return xp.zeros((n,), dtype=xp.int32)
    cap = params.vert_balance * n / k

    # native fast path (unweighted; the weighted edge-balance variant and
    # the on-device jit path stay in the vectorized implementation below)
    weighted = params.do_edge_balance and csr.vals is not None
    if not weighted:
        from ... import native

        if native.available():
            host = csr.to_host()
            if params.do_bfs_init:
                rng = np.random.default_rng(params.seed)
                seeds = rng.choice(n, size=min(k, n), replace=False)
            else:
                seeds = np.zeros(0, np.int64)
            return native.pulp(
                n,
                np.asarray(host.indptr),
                np.asarray(host.indices),
                seeds,
                k,
                cap,
                params.num_iterations,
            ).astype(np.int32)

    if params.do_bfs_init:
        labels = _bfs_seed(xp, csr, k, params.seed)
    else:
        labels = (xp.arange(n, dtype=xp.int32) * k) // max(n, 1)
    labels = labels.astype(xp.int32)

    weights = None
    if params.do_edge_balance and csr.vals is not None:
        weights = csr.vals

    labels = _propagate(xp, csr, labels, k, cap, weights, params.num_iterations)
    labels = _balance_fixup(xp, csr, labels, k, cap, weights)
    # final boundary refinement (PULP's FM-flavoured pass): reuse the
    # multilevel refiner on the (symmetrized) graph for a few rounds
    host = csr.to_host()
    from .multilevel import _refine, _symmetrize

    indptr = np.asarray(host.indptr).astype(np.int64)
    indices = np.asarray(host.indices).astype(np.int64)
    ew = (
        np.abs(np.asarray(host.vals)).astype(np.float64)
        if (params.do_edge_balance and host.vals is not None)
        else np.ones(host.nnz, np.float64)
    )
    sip, six, sew = _symmetrize(indptr, indices, ew, n)
    labels = _refine(
        sip, six, sew, np.ones(n, np.float64), np.asarray(labels).astype(np.int64),
        k, cap, rounds=4,
    )
    return labels.astype(np.int32)


def _propagate(xp, csr: CSR, labels, k, cap, weights, num_iterations):
    for it in range(num_iterations):
        counts = _neighbor_counts(xp, csr, labels, k, weights)
        if xp is np:
            sizes = np.bincount(labels, minlength=k)[:k].astype(np.float32)
        else:
            import jax.numpy as jnp

            sizes = jnp.bincount(labels, length=k).astype(jnp.float32)
        # over-capacity penalty grows through the iterations (PULP-style
        # tightening): early rounds roam, late rounds respect balance
        alpha = (it + 1) / num_iterations
        penalty = alpha * xp.maximum(sizes - cap, 0.0) * (counts.max() + 1.0) / max(cap, 1.0)
        scores = counts - penalty[None, :]
        new_labels = xp.argmax(scores, axis=1).astype(xp.int32)
        # keep isolated vertices where they are
        deg = csr.indptr[1:] - csr.indptr[:-1]
        new_labels = xp.where(deg > 0, new_labels, labels)
        if xp is np and np.array_equal(new_labels, labels):
            break
        labels = new_labels

    return labels


def _balance_fixup(xp, csr: CSR, labels, k: int, cap: float, weights):
    """Evict lowest-gain vertices from oversized parts (host-assisted;
    vectorized gain computation, greedy assignment loop over parts)."""
    labels = np.asarray(labels).copy()
    n = labels.shape[0]
    sizes = np.bincount(labels, minlength=k)[:k].astype(np.int64)
    cap_i = int(np.floor(cap))
    if (sizes <= cap_i).all():
        return labels.astype(np.int32) if isinstance(labels, np.ndarray) else labels
    host_csr = csr.to_host()
    counts = _neighbor_counts(np, host_csr, labels, k, None)
    for p in np.argsort(-sizes):
        excess = int(sizes[p]) - cap_i
        if excess <= 0:
            continue
        members = np.nonzero(labels == p)[0]
        # gain of leaving p = best other-part affinity minus p affinity
        other = counts[members].copy()
        other[:, p] = -np.inf
        best_alt = np.argmax(other, axis=1)
        gain = other[np.arange(len(members)), best_alt] - counts[members, p]
        move_order = np.argsort(-gain)
        moved = 0
        for idx in move_order:
            if moved >= excess:
                break
            tgt = int(best_alt[idx])
            if sizes[tgt] >= cap_i:
                # next best under-capacity part
                order = np.argsort(-other[idx])
                tgt = -1
                for cand in order:
                    if sizes[cand] < cap_i and cand != p:
                        tgt = int(cand)
                        break
                if tgt < 0:
                    continue
            v = int(members[idx])
            labels[v] = tgt
            sizes[p] -= 1
            sizes[tgt] += 1
            moved += 1
    return labels.astype(np.int32)


class PulpPartition(Partitioner):
    """Label-propagation k-way partitioner (PULP-equivalent, native)."""

    def __init__(self, **kw):
        super().__init__("pulp_partition")
        self.params = PulpPartitionParams(**kw)
        self.register((CSR,), lambda f, p: label_prop_partition(f[0], p))
