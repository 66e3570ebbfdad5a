"""Reverse Cuthill–McKee reordering.

JAX-native redesign of ``reorder::RCMReorder``
(reference: src/sparsebase/reorder/rcm_reorder.cc:22-166). The reference
is a sequential BFS with a min-degree priority queue per parent plus a
pseudo-peripheral root search by repeated BFS. Key observation enabling a
data-parallel formulation: the reference's visit order is exactly
reproduced by a **level-synchronous** BFS where each new level is sorted
by the lexicographic key

    (position of first-discovering parent, degree, vertex id)

because a vertex is enqueued by its minimum-position neighbor in the
previous level, and each parent's newly-discovered children are drained
from the PQ in (degree, id) order (rcm_reorder.cc:125-144). Components
are processed in ascending order of their lowest vertex id and each
component's ordering is reversed (rcm_reorder.cc:146-153).

Two implementations:

* host (numpy): vectorized level-synchronous sweep incl. the
  pseudo-peripheral root search (rcm_reorder.cc:22-81 semantics).
* device (jax): one jitted ``lax.while_loop`` over levels with
  static-shape frontiers — masks + scatter-min + a full-width
  three-key sort per level; component seeding happens inside the same
  loop; the per-component reversal is a vectorized segment-min/max.
  Root choice is the lowest unvisited vertex id (no peripheral pass),
  so device orders can differ from host orders; quality is gated on
  bandwidth/profile reduction (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.base import xp_for
from ...formats.csr import CSR
from .base import Reorderer


@dataclasses.dataclass
class RCMReorderParams:
    """Empty like the reference's (rcm_reorder.h)."""


# ---------------------------------------------------------------------------
# host implementation
# ---------------------------------------------------------------------------


def _expand_frontier_np(indptr, indices, frontier):
    """All (parent-order-index, neighbor) pairs for an ordered frontier."""
    starts = indptr[frontier]
    lens = indptr[frontier + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, indices.dtype)
    # flat gather offsets: starts repeated + within-run arange
    run_ids = np.repeat(np.arange(len(frontier)), lens)
    run_offsets = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    flat = np.repeat(starts, lens) + run_offsets
    return run_ids, indices[flat]


def _bfs_levels_np(indptr, indices, root, n):
    """Distance array (-1 unreachable) and eccentricity."""
    dist = np.full(n, -1, np.int64)
    dist[root] = 0
    frontier = np.array([root])
    level = 0
    while frontier.size:
        _, nbrs = _expand_frontier_np(indptr, indices, frontier)
        nbrs = np.unique(nbrs[dist[nbrs] < 0])
        if nbrs.size == 0:
            break
        level += 1
        dist[nbrs] = level
        frontier = nbrs
    return dist, level


def _peripheral_np(indptr, indices, start, n, degrees):
    """Pseudo-peripheral root: repeat BFS, jump to the min-degree vertex of
    the last level until eccentricity stops growing
    (rcm_reorder.cc:22-81 semantics)."""
    r = start
    prev_ecc = -1
    while True:
        dist, ecc = _bfs_levels_np(indptr, indices, r, n)
        if ecc == prev_ecc:
            return r
        prev_ecc = ecc
        last = np.nonzero(dist == ecc)[0]
        r = last[np.argmin(degrees[last])]


def _rcm_host(csr: CSR):
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    n = csr.nrows
    degrees = indptr[1:] - indptr[:-1]
    order = np.full(n, -1, np.int64)  # order[v] = final position
    visited = np.zeros(n, bool)
    counter = 0
    for i in range(n):
        if visited[i]:
            continue
        if degrees[i] == 0:
            # isolated vertices keep their scan position (rcm_reorder.cc:110-116)
            order[i] = counter
            visited[i] = True
            counter += 1
            continue
        root = _peripheral_np(indptr, indices, i, n, degrees)
        comp_start = counter
        visited[root] = True
        order[root] = counter
        counter += 1
        frontier = np.array([root])
        frontier_pos = np.array([comp_start])
        while frontier.size:
            run_ids, nbrs = _expand_frontier_np(indptr, indices, frontier)
            parent_pos = frontier_pos[run_ids]
            unv = ~visited[nbrs]
            nbrs, parent_pos = nbrs[unv], parent_pos[unv]
            if nbrs.size == 0:
                break
            # min discovering-parent position per neighbor
            minpos = np.full(n, np.iinfo(np.int64).max, np.int64)
            np.minimum.at(minpos, nbrs, parent_pos)
            nxt = np.unique(nbrs)
            key_order = np.lexsort((nxt, degrees[nxt], minpos[nxt]))
            nxt = nxt[key_order]
            visited[nxt] = True
            positions = counter + np.arange(nxt.size)
            order[nxt] = positions
            counter += nxt.size
            frontier, frontier_pos = nxt, positions
        # reverse the component (rcm_reorder.cc:146-153)
        comp = np.nonzero((order >= comp_start) & (order < counter) & (degrees > 0))[0]
        in_comp = order[comp]
        order[comp] = comp_start + (counter - 1) - in_comp
    return order.astype(np.asarray(csr.indices).dtype)


# ---------------------------------------------------------------------------
# device implementation
# ---------------------------------------------------------------------------


def _rcm_device(csr: CSR, peripheral_iters: int = 2):
    import jax
    import jax.numpy as jnp

    n = csr.nrows
    nnz = csr.nnz
    indptr = csr.indptr
    indices = csr.indices
    row_of = csr.row_of_nnz().astype(jnp.int32)
    col = indices.astype(jnp.int32)
    degrees = (indptr[1:] - indptr[:-1]).astype(jnp.int32)
    INF = jnp.int32(2**31 - 1)

    # pseudo-peripheral root for the first (usually giant) component:
    # repeated BFS restarting from a min-degree vertex of the deepest
    # level (the reference's PeripheralNode loop, rcm_reorder.cc:22-81);
    # later components fall back to lowest-id seeds.
    def _bfs_far(root):
        def bcond(s):
            _, frontier, _ = s
            return jnp.any(frontier)

        def bbody(s):
            lev, frontier, it = s
            active = frontier[row_of]
            reached = jnp.zeros((n,), bool).at[col].max(active)
            nxt = reached & (lev < 0)
            lev = jnp.where(nxt, it + 1, lev)
            return lev, nxt, it + 1

        lev0 = jnp.full((n,), -1, jnp.int32).at[root].set(0)
        f0 = jnp.zeros((n,), bool).at[root].set(True)
        lev, _, _ = jax.lax.while_loop(bcond, bbody, (lev0, f0, jnp.int32(0)))
        lev_max = jnp.max(lev)
        on_last = lev == lev_max
        min_deg = jnp.min(jnp.where(on_last, degrees, INF))
        ids = jnp.arange(n, dtype=jnp.int32)
        return jnp.min(jnp.where(on_last & (degrees == min_deg), ids, INF))

    first_root = jnp.int32(0)
    for _ in range(max(int(peripheral_iters), 0)):
        first_root = _bfs_far(first_root)

    def cond(state):
        pos, visited, curr_pos, counter, comp_of, comp_counter = state
        return ~jnp.all(visited)

    def body(state):
        pos, visited, curr_pos, counter, comp_of, comp_counter = state
        frontier_live = jnp.any(curr_pos < INF)

        def seed(args):
            pos, visited, curr_pos, counter, comp_of, comp_counter = args
            # first component: pseudo-peripheral root; later components:
            # lowest-id unvisited vertex
            lowest = jnp.argmin(jnp.where(visited, INF, jnp.arange(n, dtype=jnp.int32)))
            root = jnp.where(comp_counter == 0, first_root, lowest).astype(lowest.dtype)
            pos = pos.at[root].set(counter)
            visited = visited.at[root].set(True)
            curr_pos = jnp.full((n,), INF, jnp.int32).at[root].set(counter)
            comp_of = comp_of.at[root].set(comp_counter)
            return pos, visited, curr_pos, counter + 1, comp_of, comp_counter + 1

        def expand(args):
            pos, visited, curr_pos, counter, comp_of, comp_counter = args
            parent_pos_e = curr_pos[row_of]  # INF unless parent in frontier
            parent_comp_e = comp_of[row_of]
            # scatter-min discovering-parent position into targets
            minpos = jnp.full((n,), INF, jnp.int32).at[col].min(parent_pos_e)
            minpos = jnp.where(visited, INF, minpos)
            nxt = minpos < INF
            count = jnp.sum(nxt).astype(jnp.int32)
            # rank next-level vertices by (minpos, degree, id)
            big = jnp.where(nxt, minpos, INF)
            order_idx = jnp.lexsort((jnp.arange(n), degrees, big))  # full width
            ranks = jnp.zeros((n,), jnp.int32).at[order_idx].set(
                jnp.arange(n, dtype=jnp.int32)
            )
            new_pos = jnp.where(nxt, counter + ranks, pos)
            # propagate component id from any discovering parent (scatter-min
            # over comp works since a component's edges share one comp id)
            comp_from = jnp.full((n,), INF, jnp.int32).at[col].min(
                jnp.where(parent_pos_e < INF, parent_comp_e, INF)
            )
            comp_of = jnp.where(nxt, comp_from, comp_of)
            visited = visited | nxt
            curr_pos = jnp.where(nxt, new_pos, INF)
            return new_pos, visited, curr_pos, counter + count, comp_of, comp_counter

        return jax.lax.cond(frontier_live, expand, seed, state)

    pos0 = jnp.full((n,), -1, jnp.int32)
    visited0 = jnp.zeros((n,), bool)
    curr0 = jnp.full((n,), INF, jnp.int32)
    comp0 = jnp.zeros((n,), jnp.int32)
    # Host-chunked launch: at most K BFS rounds per device program,
    # with Python looping and syncing one "all visited" scalar per
    # launch. It bounds the length of one device program; K is not yet
    # measured on the GPU. Under an enclosing jit trace (rcm_pipeline)
    # the host loop is untraceable, so the single while_loop runs there.
    state0 = (pos0, visited0, curr0, jnp.int32(0), comp0, jnp.int32(0))
    if isinstance(csr.indptr, jax.core.Tracer):
        pos, visited, _, _, comp_of, _ = jax.lax.while_loop(
            cond, body, state0
        )
    else:
        K = 256

        @jax.jit
        def run_k(state):
            def cond_k(s):
                st, it = s
                return cond(st) & (it < K)

            def body_k(s):
                st, it = s
                return body(st), it + 1

            state, _ = jax.lax.while_loop(cond_k, body_k, (state, jnp.int32(0)))
            return state, jnp.all(state[1])

        state = state0
        while True:
            state, done = run_k(state)
            if bool(np.asarray(jax.device_get(done))):
                break
        pos, visited, _, _, comp_of, _ = state
    # per-component reversal: new = comp_min + comp_max - pos
    comp_min = jnp.full((n,), INF, jnp.int32).at[comp_of].min(pos)
    comp_max = jnp.full((n,), -1, jnp.int32).at[comp_of].max(pos)
    reversed_pos = comp_min[comp_of] + comp_max[comp_of] - pos
    return reversed_pos.astype(indices.dtype)


def _symmetrized_square(csr: CSR) -> CSR:
    """A ∪ Aᵀ pattern over max(nrows, ncols) vertices, duplicates kept.

    RCM is defined on undirected graphs; the reference implicitly assumes
    a symmetric CSR (rcm_reorder.cc BFS follows out-edges only, and a
    non-symmetric input makes its pseudo-peripheral search revisit
    earlier components and double-assign positions). Concatenating A and
    Aᵀ keeps shapes static (2·nnz) and works on either backend; for
    already-symmetric inputs every degree doubles uniformly, so tie
    orders — and hence the ordering — match the reference. Rectangular
    inputs fold row/col id spaces into one vertex set."""
    from ...convert.kernels import sort_by_pairs

    xp = xp_for(csr.indptr, csr.indices)
    n = max(csr.shape)
    row = csr.row_of_nnz()
    ur = xp.concatenate([row, csr.indices]).astype(row.dtype)
    uc = xp.concatenate([csr.indices, row]).astype(row.dtype)
    sr, sc, _ = sort_by_pairs(xp, ur, uc, None)
    if xp is np:
        counts = np.bincount(sr, minlength=n)
    else:
        import jax.numpy as jnp

        counts = jnp.bincount(sr, length=n)
    zero = xp.zeros((1,), dtype=csr.indptr.dtype)
    sp = xp.concatenate([zero, xp.cumsum(counts).astype(csr.indptr.dtype)])
    return CSR(sp, sc, None, (n, n))


def _rcm_impl(formats, params):
    csr: CSR = formats[0]
    on_device = xp_for(csr.indptr) is not np
    if on_device:
        order = _rcm_device(_symmetrized_square(csr))
    else:
        from ... import native

        if native.available():
            # native path folds + symmetrizes internally (exact mirror)
            order = native.rcm(
                csr.nrows,
                csr.ncols,
                np.asarray(csr.indptr),
                np.asarray(csr.indices),
            ).astype(np.asarray(csr.indices).dtype)
        else:
            order = _rcm_host(_symmetrized_square(csr))
    if max(csr.shape) != csr.nrows:
        # compress the folded ordering to a row permutation: rank the
        # first nrows vertices by their fold positions
        pos = np.asarray(order)[: csr.nrows]
        ranks = np.empty(csr.nrows, dtype=pos.dtype)
        ranks[np.argsort(pos, kind="stable")] = np.arange(csr.nrows, dtype=pos.dtype)
        return ranks
    return order


class RCMReorder(Reorderer):
    def __init__(self, params: RCMReorderParams | None = None):
        super().__init__("rcm_reorder")
        self.params = params or RCMReorderParams()
        self.register((CSR,), _rcm_impl)
