"""Distributed kernels over ShardedCSR via shard_map + collectives.

The north-star layer (SURVEY.md §2.13, §5 "distributed communication
backend"): the reference's only inter-device path is a CUDA P2P memcpy
(converter/converter_cuda.cu:12-22); here sparse preprocessing runs SPMD
over a mesh with XLA collectives (``psum`` / ``all_gather``) over the interconnect:

* :func:`spmv` — row-sharded SpMV, replicated x, sharded y
* :func:`degrees` — per-vertex degrees, sharded rows
* :func:`bfs_levels` — level-synchronous frontier BFS; the frontier
  exchange is a ``psum`` (dense; see :mod:`.halo` for the
  boundary-proportional all_to_all variant)
* :func:`degree_reorder` — distributed counting-sort reorder
* :func:`label_prop_partition` — distributed size-constrained label
  propagation (PULP-style) with ``psum``'d part sizes

All functions jit/compile on any mesh size — tests use the virtual
8-device CPU mesh; the driver dry-runs the same path. Compiled runners
are cached per (mesh, static shapes) so repeated calls pay
tracing/compilation once.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from .sharded import ShardedCSR


def _local_row_of(indptr_local, width):
    """Row id (local) of every nnz slot in a padded shard — scatter row
    markers + prefix sum (no per-element searchsorted loop)."""
    marks = jnp.zeros((width,), jnp.int32).at[indptr_local[:-1]].add(1, mode="drop")
    return jnp.cumsum(marks) - 1


def _statics(sh: ShardedCSR):
    return (sh.axis, sh.shape[0], sh.n_shards, sh.rows_per_shard, sh.indices.shape[1])


@functools.lru_cache(maxsize=None)
def _spmv_runner(mesh, axis, n, d, rows, width):
    def body(indptr, indices, vals, nnz_local, xx):
        indptr = indptr[0]
        indices = indices[0]
        vals = vals[0]
        cnt = nnz_local[0]
        lrow = _local_row_of(indptr, width)
        valid = jnp.arange(width, dtype=jnp.int32) < cnt
        prod = jnp.where(valid, vals * xx[indices], 0)
        y = jax.ops.segment_sum(prod, lrow, num_segments=rows)
        return y[None, :]

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    return jax.jit(fn)


def spmv(sh: ShardedCSR, x, mesh: Mesh):
    """y = A @ x with A row-sharded and x replicated; y sharded by rows."""
    axis, n, d, rows, width = _statics(sh)
    f = _spmv_runner(mesh, axis, n, d, rows, width)
    vals = sh.vals if sh.vals is not None else jnp.ones(sh.indices.shape, jnp.float32)
    y = f(sh.indptr, sh.indices, vals, sh.nnz_local, x)
    return y.reshape(-1)[:n]


@functools.lru_cache(maxsize=None)
def _degrees_runner(mesh, axis):
    def body(indptr):
        return indptr[:, 1:] - indptr[:, :-1]

    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(axis),), out_specs=P(axis)))


def degrees(sh: ShardedCSR, mesh: Mesh):
    """Per-vertex degree, sharded by rows."""
    n = sh.shape[0]
    return _degrees_runner(mesh, sh.axis)(sh.indptr).reshape(-1)[:n]


@functools.lru_cache(maxsize=None)
def _bfs_runner(mesh, axis, n, d, rows, width, iters):
    def step(indptr, indices, nnz_local, frontier):
        # frontier: replicated (n,) bool. Local rows: global ids
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        row_base = shard_id * rows
        lrow = _local_row_of(indptr_l, width)
        grow = row_base + lrow
        valid = (jnp.arange(width, dtype=jnp.int32) < cnt) & (grow < n)
        active = valid & frontier[jnp.clip(grow, 0, n - 1)]
        reached_local = (
            jnp.zeros((n,), jnp.int32).at[indices_l].max(active.astype(jnp.int32))
        )
        # halo exchange: union of all shards' reach sets
        return jax.lax.psum(reached_local, axis) > 0

    step_fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(),
    )

    @jax.jit
    def run(indptr, indices, nnz_local, root):
        levels0 = jnp.full((n,), -1, jnp.int32).at[root].set(0)
        frontier0 = jnp.zeros((n,), bool).at[root].set(True)

        def cond(state):
            levels, frontier, it = state
            return jnp.any(frontier) & (it < iters)

        def body(state):
            levels, frontier, it = state
            reached = step_fn(indptr, indices, nnz_local, frontier)
            nxt = reached & (levels < 0)
            levels = jnp.where(nxt, it + 1, levels)
            return levels, nxt, it + 1

        levels, _, _ = jax.lax.while_loop(cond, body, (levels0, frontier0, jnp.int32(0)))
        return levels

    return run


def bfs_levels(sh: ShardedCSR, root: int, mesh: Mesh, max_iters: Optional[int] = None):
    """Level-synchronous BFS from ``root``; returns replicated (n,) levels
    (-1 = unreached). Frontier exchange = psum over the mesh axis."""
    axis, n, d, rows, width = _statics(sh)
    run = _bfs_runner(mesh, axis, n, d, rows, width, max_iters or n)
    return run(sh.indptr, sh.indices, sh.nnz_local, jnp.asarray(root, jnp.int32))


def degree_reorder(sh: ShardedCSR, mesh: Mesh, ascending: bool = True):
    """Distributed degree reorder: sharded degree computation + global
    rank (inverse permutation, replicated)."""
    deg = degrees(sh, mesh)
    keys = deg if ascending else -deg
    perm = jnp.argsort(keys, stable=True)
    n = sh.shape[0]
    return jnp.zeros((n,), jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))


@functools.lru_cache(maxsize=None)
def _rcm_rank_runner(n):
    @jax.jit
    def rank(levels, deg):
        unreached = levels < 0
        lev = jnp.where(unreached, n, levels)  # components after the BFS tree
        order = jnp.lexsort((jnp.arange(n), deg, lev))  # order[new] = old
        pos = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
        # reverse the reached part only (Cuthill-McKee -> RCM)
        reached_count = jnp.sum(~unreached).astype(jnp.int32)
        rev = jnp.where(pos < reached_count, reached_count - 1 - pos, pos)
        return rev

    return rank


def rcm_reorder(sh: ShardedCSR, mesh: Mesh, root: int = 0, max_iters: Optional[int] = None):
    """Distributed level-synchronous RCM over a sharded CSR.

    The distributed-memory RCM recipe (PAPERS.md: Azad & Buluç,
    "The Reverse Cuthill-McKee Algorithm in Distributed-Memory"): BFS
    levels via the sharded frontier exchange, then rank vertices by the
    lexicographic key (level, degree, id) — a level-synchronous
    approximation of host RCM — and reverse. Unreached vertices (other
    components) are appended after, in id order. Returns a replicated
    inverse permutation.

    The (n,)-replicated lexsort rank here is the simple/dense variant;
    :func:`.halo.rcm_reorder` ranks distributively (counting rank over
    psum'd histograms) with a pseudo-peripheral root pass."""
    n = sh.shape[0]
    levels = bfs_levels(sh, root, mesh, max_iters=max_iters)
    deg = degrees(sh, mesh)
    return _rcm_rank_runner(n)(levels, deg)


@functools.lru_cache(maxsize=None)
def _edge_cut_runner(mesh, axis, n, d, rows, width):
    def body(indptr, indices, nnz_local, lab):
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        grow = shard_id * rows + _local_row_of(indptr_l, width)
        valid = (jnp.arange(width, dtype=jnp.int32) < cnt) & (grow < n)
        crossing = valid & (
            lab[jnp.clip(grow, 0, n - 1)] != lab[jnp.clip(indices_l, 0, n - 1)]
        )
        return jax.lax.psum(jnp.sum(crossing.astype(jnp.int32)), axis)

    fn = shard_map(
        body, mesh=mesh, in_specs=(P(axis), P(axis), P(axis), P()), out_specs=P()
    )
    return jax.jit(fn)


def edge_cut(sh: ShardedCSR, labels, mesh: Mesh):
    """Total directed edge cut of a labeling: psum of per-shard counts of
    entries whose row/col labels differ (the edge-cut reduction collective
    from SURVEY.md §2.13's north star)."""
    axis, n, d, rows, width = _statics(sh)
    f = _edge_cut_runner(mesh, axis, n, d, rows, width)
    return f(sh.indptr, sh.indices, sh.nnz_local, jnp.asarray(labels))


@functools.lru_cache(maxsize=None)
def _refine_runner(mesh, axis, n, d, rows, width, k, rounds, cap):
    def step(indptr, indices, nnz_local, lab):
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        row_base = shard_id * rows
        lrow = _local_row_of(indptr_l, width)
        valid = jnp.arange(width, dtype=jnp.int32) < cnt
        counts = (
            jnp.zeros((rows, k), jnp.float32)
            .at[lrow, lab[jnp.clip(indices_l, 0, n - 1)]]
            .add(valid.astype(jnp.float32))
        )
        grows = row_base + jnp.arange(rows)
        in_range = grows < n
        cur = lab[jnp.clip(grows, 0, n - 1)]
        local_sizes = jnp.zeros((k,), jnp.float32).at[cur].add(
            in_range.astype(jnp.float32)
        )
        sizes = jax.lax.psum(local_sizes, axis)
        # gain of moving each local row to each part; full parts excluded
        full = sizes >= cap
        cur_aff = jnp.take_along_axis(counts, cur[:, None], axis=1)[:, 0]
        masked = jnp.where(full[None, :], -jnp.inf, counts)
        masked = masked.at[jnp.arange(rows), cur].set(-jnp.inf)
        best = jnp.argmax(masked, axis=1).astype(jnp.int32)
        gain = jnp.where(in_range, jnp.max(masked, axis=1) - cur_aff, -jnp.inf)
        return gain[None, :], best[None, :], sizes

    step_fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P()),
    )

    def cut_body(indptr, indices, nnz_local, lab):
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        grow = shard_id * rows + _local_row_of(indptr_l, width)
        valid = (jnp.arange(width, dtype=jnp.int32) < cnt) & (grow < n)
        crossing = valid & (
            lab[jnp.clip(grow, 0, n - 1)] != lab[jnp.clip(indices_l, 0, n - 1)]
        )
        return jax.lax.psum(jnp.sum(crossing.astype(jnp.int32)), axis)

    cut_fn = shard_map(
        cut_body, mesh=mesh, in_specs=(P(axis), P(axis), P(axis), P()), out_specs=P()
    )

    @jax.jit
    def run(indptr, indices, nnz_local, labels):
        def body(_, state):
            lab, best_lab, best_cut = state
            gain_sh, best_sh, sizes = step_fn(indptr, indices, nnz_local, lab)
            gain = gain_sh.reshape(-1)[:n]
            best = best_sh.reshape(-1)[:n]
            # admission control on the replicated state: movers ranked by
            # gain within each target part; only headroom-many admitted —
            # a whole round can never push a part past the cap
            headroom = jnp.maximum(jnp.floor(cap - sizes), 0.0)
            order = jnp.lexsort((jnp.arange(n), -gain, best))
            best_s = best[order]
            pos = jnp.arange(n)
            start = jnp.full((k,), n).at[best_s].min(pos)
            rank = pos - start[best_s]
            admit_s = (gain[order] > 0) & (rank < headroom[best_s])
            admit = jnp.zeros((n,), bool).at[order].set(admit_s)
            new_lab = jnp.where(admit, best, lab)
            # simultaneous moves can conflict and raise the cut; keep the
            # best labeling seen so the result is monotone vs the input
            new_cut = cut_fn(indptr, indices, nnz_local, new_lab)
            better = new_cut < best_cut
            best_lab = jnp.where(better, new_lab, best_lab)
            best_cut = jnp.where(better, new_cut, best_cut)
            return new_lab, best_lab, best_cut

        cut0 = cut_fn(indptr, indices, nnz_local, labels)
        _, best_lab, _ = jax.lax.fori_loop(0, rounds, body, (labels, labels, cut0))
        return best_lab

    return run


def refine_partition(
    sh: ShardedCSR,
    labels,
    k: int,
    mesh: Mesh,
    rounds: int = 4,
    balance: float = 1.1,
):
    """Distributed boundary refinement: per-round, every shard computes
    its rows' label affinities locally, part sizes are ``psum``'d, and
    positive-gain moves into under-capacity parts are applied (the
    "partition refinement with psum'd gain reduction" north-star item,
    SURVEY.md §2.13/§7 phase 5). Overshoot self-corrects next round since
    sizes are re-reduced. Returns the refined replicated labels."""
    axis, n, d, rows, width = _statics(sh)
    cap = balance * n / k
    run = _refine_runner(mesh, axis, n, d, rows, width, int(k), int(rounds), cap)
    return run(sh.indptr, sh.indices, sh.nnz_local, jnp.asarray(labels))


@functools.lru_cache(maxsize=None)
def _structure_runner(mesh, axis, n, d, rows, width):
    def body(indptr, indices, nnz_local):
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        grow = (shard_id * rows + _local_row_of(indptr_l, width)).astype(jnp.int32)
        valid = (jnp.arange(width, dtype=jnp.int32) < cnt) & (grow < n)
        span = jnp.where(valid, jnp.abs(grow - indices_l) + 1, 0)
        bw = jax.lax.pmax(jnp.max(span), axis)
        # profile: sum over rows of (row - min col) for rows with entries
        mincol = (
            jnp.full((rows,), jnp.iinfo(jnp.int32).max, jnp.int32)
            .at[_local_row_of(indptr_l, width)]
            .min(jnp.where(valid, indices_l, jnp.iinfo(jnp.int32).max))
        )
        grows = (shard_id * rows + jnp.arange(rows)).astype(jnp.int32)
        has = (indptr_l[1:] > indptr_l[:-1]) & (grows < n)
        # f32 accumulation: x64 is off and int32
        # overflows past 2^31; f32 keeps ~7 digits which property tests use
        prof_local = jnp.sum(
            jnp.where(has, jnp.maximum(grows - mincol, 0), 0).astype(jnp.float32)
        )
        prof = jax.lax.psum(prof_local, axis)
        nnz = jax.lax.psum(cnt.astype(jnp.int32), axis)
        # degree scalars (GraphFeatureBase min/max/avg parity): pad rows
        # (global id ≥ n) are excluded from the min/max reductions
        deg_l = (indptr_l[1:] - indptr_l[:-1]).astype(jnp.int32)
        big = jnp.iinfo(jnp.int32).max
        min_deg = jax.lax.pmin(
            jnp.min(jnp.where(grows < n, deg_l, big)), axis
        )
        max_deg = jax.lax.pmax(jnp.max(jnp.where(grows < n, deg_l, 0)), axis)
        return bw, prof, nnz, min_deg, max_deg

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(),) * 5,
    )
    return jax.jit(fn)


def structure_features(sh: ShardedCSR, mesh: Mesh):
    """Distributed bandwidth / profile / nnz / min/max/avg degree in one
    pass: per-shard reductions combined with ``psum``/``pmax``/``pmin``
    (the GraphFeatureBase scalars over a sharded matrix). Returns a dict
    of replicated scalars."""
    axis, n, d, rows, width = _statics(sh)
    f = _structure_runner(mesh, axis, n, d, rows, width)
    bw, prof, nnz, min_deg, max_deg = f(sh.indptr, sh.indices, sh.nnz_local)
    return {
        "bandwidth": bw,
        "profile": prof,
        "nnz": nnz,
        "min_degree": min_deg,
        "max_degree": max_deg,
        "avg_degree": nnz.astype(jnp.float32) / max(n, 1),
    }


@functools.lru_cache(maxsize=None)
def _labelprop_runner(mesh, axis, n, d, rows, width, k, num_iters, cap):
    def step(indptr, indices, nnz_local, labels, it):
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        row_base = shard_id * rows
        lrow = _local_row_of(indptr_l, width)
        valid = jnp.arange(width, dtype=jnp.int32) < cnt
        counts = (
            jnp.zeros((rows, k), jnp.float32)
            .at[lrow, labels[indices_l]]
            .add(valid.astype(jnp.float32))
        )
        grows = row_base + jnp.arange(rows)
        local_labels = labels[jnp.clip(grows, 0, n - 1)]
        local_sizes = (
            jnp.zeros((k,), jnp.float32)
            .at[local_labels]
            .add((grows < n).astype(jnp.float32))
        )
        sizes = jax.lax.psum(local_sizes, axis)
        # PULP-style multiplicative balance weight + strict-improvement
        # moves on alternating halves (see halo.label_prop_partition)
        weight = jnp.maximum(1.0 - sizes / cap, 0.0)
        scores = counts * weight[None, :]
        cur_score = jnp.take_along_axis(
            scores, local_labels[:, None].astype(jnp.int32), 1
        )[:, 0]
        best = jnp.argmax(scores, axis=1).astype(jnp.int32)
        best_score = jnp.max(scores, axis=1)
        active = ((grows + it) % 2 == 0) & ((indptr_l[1:] - indptr_l[:-1]) > 0)
        # never empty a part (see halo.label_prop_partition)
        keeps_alive = sizes[jnp.clip(local_labels, 0, k - 1)] > 1.5
        return jnp.where(
            active & keeps_alive & (best_score > cur_score * 1.000001 + 1e-6),
            best, local_labels,
        )[None, :]

    step_fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
    )

    @jax.jit
    def run(indptr, indices, nnz_local):
        labels0 = (jnp.arange(n, dtype=jnp.int32) * k) // max(n, 1)

        def body(i, labels):
            new_sharded = step_fn(indptr, indices, nnz_local, labels, i)
            return new_sharded.reshape(-1)[:n]

        return jax.lax.fori_loop(0, num_iters, body, labels0)

    return run


def label_prop_partition(
    sh: ShardedCSR,
    k: int,
    mesh: Mesh,
    num_iters: int = 10,
    balance: float = 1.1,
):
    """Distributed size-constrained label propagation (PULP-equivalent,
    distributed): labels replicated, per-shard neighbor counts, psum'd
    part sizes; returns replicated (n,) labels."""
    axis, n, d, rows, width = _statics(sh)
    cap = balance * n / k
    run = _labelprop_runner(mesh, axis, n, d, rows, width, int(k), int(num_iters), cap)
    return run(sh.indptr, sh.indices, sh.nnz_local)


@functools.lru_cache(maxsize=None)
def _heatmap_runner(mesh, axis, n, m, d, rows, width, b):
    bsize = max(n // b, 1)

    def body(indptr, indices, nnz_local, order_r, order_c):
        indptr_l = indptr[0]
        indices_l = indices[0]
        cnt = nnz_local[0]
        shard_id = jax.lax.axis_index(axis)
        grow = shard_id * rows + _local_row_of(indptr_l, width)
        valid = (jnp.arange(width, dtype=jnp.int32) < cnt) & (grow < n)
        u = order_r[jnp.clip(grow, 0, n - 1)]
        v = order_c[jnp.clip(indices_l, 0, m - 1)]
        bu = jnp.minimum(u // bsize, b - 1)
        bv = jnp.minimum(v // bsize, b - 1)
        flat = jnp.where(valid, bu * b + bv, b * b)
        hist = jnp.zeros((b * b,), jnp.int32).at[flat].add(
            valid.astype(jnp.int32), mode="drop"
        )
        return jax.lax.psum(hist, axis)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(),
    )
    return jax.jit(fn)


def reorder_heatmap(sh: ShardedCSR, order_r, order_c, mesh: Mesh, num_parts: int = 8):
    """Distributed b×b block-density heatmap of a reordered sharded matrix
    — per-shard scatter-add histograms combined with a (b²,) psum (the
    ReorderHeatmap op, reorder_heatmap.cc:42-120, over a mesh). Returns
    the replicated (b, b) density grid (counts / nnz)."""
    axis, n, d, rows, width = _statics(sh)
    m = sh.shape[1]
    f = _heatmap_runner(mesh, axis, n, m, d, rows, width, int(num_parts))
    counts = f(sh.indptr, sh.indices, sh.nnz_local,
               jnp.asarray(order_r), jnp.asarray(order_c))
    nnz = max(sh.nnz, 1)
    return counts.reshape(num_parts, num_parts).astype(jnp.float32) / nnz
