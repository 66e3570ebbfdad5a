"""Ring-collective matmul kernels over ShardedCSR: distributed triangle
counting and per-edge Jaccard weights.

The reference's only GPU kernel is Jaccard (reference:
src/sparsebase/feature/jaccard_weights_cuda.cu:8-150, a binary-search
warp kernel on one device) and its TriangleCount is sequential host code
(reference: src/sparsebase/feature/triangle_count.cc:141-205). The
recast here moves both onto **matrix products**: neighborhood
intersections are exactly the entries of ``A·Aᵀ`` (and triangles the
entries of ``A²`` masked by ``A``), so each device densifies its local
row block to a 0/1 ``bfloat16`` tile and the full products are built by
a **ring all-gather matmul** — each step multiplies against the visiting
row block and forwards it to the mesh neighbor with
``jax.lax.ppermute``, the classic collective-matmul overlap pattern
(compute on block k while block k+1 crosses the interconnect; XLA
schedules the ``ppermute`` concurrently with the ``dot``). This
completes the collective family used by the package: ``psum`` / ``all_gather`` /
``all_to_all`` / ``reduce_scatter`` (:mod:`.sharded2d`) / ``ppermute``
(here).

Counts are exact: 0/1 values are exact in bf16, products accumulate in
f32 (``preferred_element_type``) where every per-entry count is ≤ n <
2²⁴, and the *global* triangle total — which can exceed f32's 2²⁴
integer range — is reconstructed exactly from a wrapped-int32 psum plus
an approximate f32 psum (``utils.exact.combine_wrapped``; valid to
~10¹³ triangles). Duplicate CSR entries are counted once (set
semantics, the CSR
invariant); the host paths treat lists as multisets, so feed
deduplicated structures when comparing. Memory is the method's limit — each device holds O(rows·n) dense
tiles — so these kernels target the bench/feature scale (n up to a few
10⁵ on a real mesh), not the 100M-nnz ingest scale; the sparse
binary-search formulation (:mod:`..ops.feature.jaccard`) remains the
single-chip big-n path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..utils.exact import combine_wrapped, ratio_f32
from .dist import _local_row_of, _statics
from .sharded import ShardedCSR

MAX_DENSE_ELEMS = 1 << 30  # per-device tile guard (~2 GB bf16)


def _vary(x, axis):
    """Mark a replicated-constant carry as device-varying so fori_loop
    carries typecheck under shard_map's varying-manual-axes tracking."""
    pcast = getattr(jax.lax, "pcast", None)
    if pcast is not None:
        return pcast(x, (axis,), to="varying")
    return jax.lax.pvary(x, (axis,))


def _densify(indptr_l, indices_l, cnt, i, rows, width, np_pad, zero_diag):
    """Local 0/1 bf16 row-block tile (rows, np_pad) from padded CSR."""
    lrow = _local_row_of(indptr_l, width)
    valid = jnp.arange(width, dtype=jnp.int32) < cnt
    one = jnp.ones((width,), jnp.bfloat16)
    dense = (
        jnp.zeros((rows, np_pad), jnp.bfloat16)
        .at[lrow, indices_l]
        .max(jnp.where(valid, one, 0), mode="drop")
    )
    if zero_diag:
        gcols = jnp.arange(np_pad, dtype=jnp.int32)[None, :]
        grows = (i * rows + jnp.arange(rows, dtype=jnp.int32))[:, None]
        dense = jnp.where(gcols == grows, jnp.bfloat16(0), dense)
    return dense


@functools.lru_cache(maxsize=None)
def _triangle_runner(mesh, axis, n, d, rows, width, directed):
    np_pad = d * rows
    perm = [(j, (j - 1) % d) for j in range(d)]

    def body(indptr, indices, nnz_local):
        indptr_l, indices_l, cnt = indptr[0], indices[0], nnz_local[0]
        i = jax.lax.axis_index(axis)
        dense = _densify(indptr_l, indices_l, cnt, i, rows, width, np_pad, True)

        def step(k, carry):
            blk, acc, at = carry
            src = jax.lax.rem(i + k, d)  # owner of the visiting block
            # row-block of A²: acc += A_i[:, src-block] @ A_src
            sl = jax.lax.dynamic_slice(dense, (0, src * rows), (rows, rows))
            acc = acc + jnp.dot(sl, blk, preferred_element_type=jnp.float32)
            # row-block of Aᵀ: my column window of the visiting block
            win = jax.lax.dynamic_slice(blk, (0, i * rows), (rows, rows))
            at = jax.lax.dynamic_update_slice(at, win.T, (0, src * rows))
            blk = jax.lax.ppermute(blk, axis, perm)
            return blk, acc, at

        init = (
            dense,
            _vary(jnp.zeros((rows, np_pad), jnp.float32), axis),
            _vary(jnp.zeros((rows, np_pad), jnp.bfloat16), axis),
        )
        _, sq, at = jax.lax.fori_loop(0, d, step, init)
        if directed:
            # directed 3-cycles u→v→w→u, each once: Σ A²[v,u]·A[u,v] / 3
            prod = sq * at.astype(jnp.float32)
        else:
            # symmetric A: Σ A²[u,v]·A[u,v] counts each triangle 6×
            prod = sq * dense.astype(jnp.float32)
        # prod entries are exact f32 integers ≤ n; recover the exact
        # global total from (wrapped int32 psum, approximate f32 psum)
        # — see utils.exact (a bare f32 reduction drifts past 2²⁴).
        wrapped = jax.lax.psum(jnp.sum(prod.astype(jnp.int32)), axis)
        approx = jax.lax.psum(jnp.sum(prod), axis)
        return wrapped, approx

    fn = shard_map(
        body, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)), out_specs=(P(), P())
    )
    return jax.jit(fn)


def triangle_count(sh: ShardedCSR, mesh: Mesh, directed: bool = False) -> int:
    """Distributed triangle count (reference TriangleCount semantics:
    triangle_count.cc:141-205 — undirected assumes a symmetric adjacency
    and counts each triangle once; directed counts 3-cycles once each).
    Self-loops are ignored (diagonal zeroed before the products)."""
    axis, n, d, rows, width = _statics(sh)
    if rows * d * rows > MAX_DENSE_ELEMS:
        if directed:
            raise ValueError(
                "ring.triangle_count: matrix too large for the dense ring "
                "path and the sparse ring implements undirected counting "
                "only (directed 3-cycles need the Aᵀ tile)"
            )
        return triangle_count_sparse(sh, mesh)
    f = _triangle_runner(mesh, axis, n, d, rows, width, bool(directed))
    wrapped, approx = f(sh.indptr, sh.indices, sh.nnz_local)
    total = combine_wrapped(
        int(np.asarray(jax.device_get(wrapped))),
        float(np.asarray(jax.device_get(approx))),
    )
    return total // (3 if directed else 6)


@functools.lru_cache(maxsize=None)
def _jaccard_runner(mesh, axis, n, d, rows, width):
    np_pad = d * rows
    perm = [(j, (j - 1) % d) for j in range(d)]

    def body(indptr, indices, nnz_local):
        indptr_l, indices_l, cnt = indptr[0], indices[0], nnz_local[0]
        i = jax.lax.axis_index(axis)
        # keep self-loops: |N(u)∩N(v)| = (A·Aᵀ)[u,v] exactly, as in the
        # reference's set intersection (jaccard_weights_cuda.cu:70-91)
        dense = _densify(indptr_l, indices_l, cnt, i, rows, width, np_pad, False)

        def step(k, carry):
            blk, inter = carry
            src = jax.lax.rem(i + k, d)
            # C_i[:, src-block] = A_i @ A_srcᵀ
            prod = jnp.dot(dense, blk.T, preferred_element_type=jnp.float32)
            inter = jax.lax.dynamic_update_slice(inter, prod, (0, src * rows))
            blk = jax.lax.ppermute(blk, axis, perm)
            return blk, inter

        _, inter = jax.lax.fori_loop(
            0, d, step, (dense, _vary(jnp.zeros((rows, np_pad), jnp.float32), axis))
        )
        lrow = _local_row_of(indptr_l, width)
        valid = jnp.arange(width, dtype=jnp.int32) < cnt
        common = inter[lrow, indices_l]
        deg_l = (indptr_l[1:] - indptr_l[:-1]).astype(jnp.float32)
        deg_all = jax.lax.all_gather(deg_l, axis).reshape(-1)  # (np_pad,)
        union = deg_l[lrow] + deg_all[indices_l] - common
        ratio = ratio_f32(common.astype(jnp.int32), jnp.maximum(union, 1.0).astype(jnp.int32))
        jac = jnp.where(valid, ratio, 0.0)
        return jac[None, :]

    fn = shard_map(
        body, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)), out_specs=P(axis)
    )
    return jax.jit(fn)


def jaccard_weights(sh: ShardedCSR, mesh: Mesh):
    """Distributed per-edge Jaccard weights, (D, width) padded array
    parallel to ``sh.indices`` (pad slots 0). Same per-directed-edge
    semantics as :mod:`..ops.feature.jaccard` — J(u,v) =
    |N(u)∩N(v)| / |N(u)∪N(v)| over out-neighborhoods."""
    axis, n, d, rows, width = _statics(sh)
    if rows * d * rows > MAX_DENSE_ELEMS:
        return jaccard_weights_sparse(sh, mesh)
    f = _jaccard_runner(mesh, axis, n, d, rows, width)
    return f(sh.indptr, sh.indices, sh.nnz_local)


# ---------------------------------------------------------------------------
# sparse ring (big-n path): rotate CSR row blocks, binary-search intersections
# ---------------------------------------------------------------------------
#
# The dense ring above densifies O(rows·n) tiles per device, refusing
# past MAX_DENSE_ELEMS (n ≈ 1e5 at d=8). The sparse ring is its big-n
# twin — the distributed form of the single-chip binary-search
# formulation (ops/feature/triangles.py, ops/feature/jaccard.py;
# reference: src/sparsebase/feature/jaccard_weights_cuda.cu:8-100):
#
# * only the CSR row block (indptr, indices) rides the ring — comm per
#   device is O(n + nnz) total over d steps, no padding blowup;
# * local edges are sorted by owner(target) once, and each ring step
#   processes one owner segment through a fixed pmax-sized budget window
#   (two-pass sizing, the same pattern as the halo builder), so work is
#   O(Σ_e deg(u_e) · log deg) spread over the steps, not d× it;
# * per-edge |N(u) ∩ N(v)| = binary search of N(u)'s elements (chunked
#   to bound the (budget, chunk) tile) in the visiting block's row v.
#
# Crossover: use the dense ring while rows·n ≤ MAX_DENSE_ELEMS (the
# bf16 matmuls; not yet measured against the sparse ring on the GPU);
# past the memory wall the sparse ring is the only path and `triangle_count` /
# `jaccard_weights` fall back to it automatically.

_CAND_CHUNK = 128  # candidate-tile minor size: bounds (budget, chunk) temps


@functools.lru_cache(maxsize=None)
def _sparse_sizing_runner(mesh, axis, d, rows, width):
    """Pass 1: (global max row degree, max per-(device,owner) edge count)."""

    def body(indptr, indices, nnz_local):
        ip, ind, cnt = indptr[0], indices[0], nnz_local[0]
        deg = ip[1:] - ip[:-1]
        wmax = jax.lax.pmax(jnp.max(deg), axis)
        slot = jnp.arange(width, dtype=jnp.int32)
        owner = jnp.where(
            slot < cnt, jnp.minimum(ind // max(rows, 1), d - 1), d
        )
        counts = jax.ops.segment_sum(
            jnp.ones((width,), jnp.int32), owner, num_segments=d + 1
        )[:d]
        bmax = jax.lax.pmax(jnp.max(counts), axis)
        return wmax[None], bmax[None]

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def _sparse_common_runner(mesh, axis, n, d, rows, width, wmax, budget, mode):
    """Per-local-edge |N(u) ∩ N(v)| over the ring. ``mode``:
    ``"jaccard"`` → per-edge weights (keeps self-loops, like the dense
    ring); ``"triangles"`` → (wrapped, approx) global Σ common over
    simple-graph edges (diagonal and endpoint candidates masked)."""
    np_pad = d * rows
    perm = [(j, (j - 1) % d) for j in range(d)]
    rounds = max(int(wmax).bit_length(), 1)
    n_chunks = -(-wmax // _CAND_CHUNK)

    def body(indptr, indices, nnz_local):
        ip, ind, cnt = indptr[0], indices[0], nnz_local[0]
        i = jax.lax.axis_index(axis)
        lrow = _local_row_of(ip, width)
        slot = jnp.arange(width, dtype=jnp.int32)
        valid = slot < cnt
        owner = jnp.where(valid, jnp.minimum(ind // max(rows, 1), d - 1), d)
        _, ss = jax.lax.sort((owner, slot), num_keys=1, is_stable=False)
        counts = jax.ops.segment_sum(
            jnp.ones((width,), jnp.int32), owner, num_segments=d + 1
        )[:d]
        seg = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)]
        )
        ss_p = jnp.concatenate([ss, jnp.full((budget,), width, jnp.int32)])

        def step(k, carry):
            ip_v, ind_v, common = carry
            src = jax.lax.rem(i + k, d)
            start = seg[src]
            w = jax.lax.dynamic_slice(ss_p, (start,), (budget,))
            in_seg = jnp.arange(budget, dtype=jnp.int32) < (seg[src + 1] - start)
            em = in_seg & (w < width)
            e = jnp.minimum(w, width - 1)
            u_loc = lrow[e]
            v = ind[e]
            v_loc = jnp.clip(v - src * rows, 0, rows - 1)
            su = ip[u_loc]
            du = ip[u_loc + 1] - su
            lo0 = ip_v[v_loc]
            hi0 = ip_v[v_loc + 1]
            u_g = i * rows + u_loc

            def chunk(ci, acc):
                t = ci * _CAND_CHUNK + jnp.arange(_CAND_CHUNK, dtype=jnp.int32)
                cand = ind[jnp.minimum(su[:, None] + t[None, :], width - 1)]
                cva = (t[None, :] < du[:, None]) & em[:, None]
                # set semantics: duplicated entries in sorted N(u) count
                # once (visiting-side duplicates collapse via lower_bound)
                prev = ind[
                    jnp.minimum(jnp.maximum(su[:, None] + t[None, :] - 1, 0), width - 1)
                ]
                cva = cva & ((t[None, :] == 0) | (prev != cand))
                if mode == "triangles":
                    cva = (
                        cva
                        & (cand != u_g[:, None])
                        & (cand != v[:, None])
                        & (u_g != v)[:, None]
                    )
                left = jnp.broadcast_to(lo0[:, None], cand.shape)
                right = jnp.broadcast_to(hi0[:, None], cand.shape)
                for _ in range(rounds):
                    active = left < right
                    mid = (left + right) // 2
                    mv = ind_v[jnp.minimum(mid, width - 1)]
                    go = active & (mv < cand)
                    left = jnp.where(go, mid + 1, left)
                    right = jnp.where(active & ~go, mid, right)
                found = (
                    (left < hi0[:, None])
                    & (ind_v[jnp.minimum(left, width - 1)] == cand)
                    & cva
                )
                return acc + found.sum(axis=1).astype(jnp.int32)

            cnts = jax.lax.fori_loop(
                0, n_chunks, chunk, _vary(jnp.zeros((budget,), jnp.int32), axis)
            )
            common = common.at[w].add(jnp.where(em, cnts, 0), mode="drop")
            ip_v = jax.lax.ppermute(ip_v, axis, perm)
            ind_v = jax.lax.ppermute(ind_v, axis, perm)
            return ip_v, ind_v, common

        init = (ip, ind, _vary(jnp.zeros((width,), jnp.int32), axis))
        _, _, common = jax.lax.fori_loop(0, d, step, init)
        if mode == "triangles":
            wrapped = jax.lax.psum(jnp.sum(common), axis)
            approx = jax.lax.psum(jnp.sum(common.astype(jnp.float32)), axis)
            return wrapped[None], approx[None]
        deg_l = (ip[1:] - ip[:-1]).astype(jnp.float32)
        deg_all = jax.lax.all_gather(deg_l, axis).reshape(-1)
        cf = common.astype(jnp.float32)
        union = deg_l[lrow] + deg_all[jnp.minimum(ind, np_pad - 1)] - cf
        ratio = ratio_f32(common, jnp.maximum(union, 1.0).astype(jnp.int32))
        jac = jnp.where(valid, ratio, 0.0)
        return jac[None, :]

    out_specs = (P(), P()) if mode == "triangles" else P(axis)
    fn = shard_map(
        body, mesh=mesh, in_specs=(P(axis), P(axis), P(axis)), out_specs=out_specs
    )
    return jax.jit(fn)


def _sparse_sizes(sh: ShardedCSR, mesh: Mesh):
    axis, n, d, rows, width = _statics(sh)
    wmax, bmax = _sparse_sizing_runner(mesh, axis, d, rows, width)(
        sh.indptr, sh.indices, sh.nnz_local
    )
    return (
        _pow2(int(np.asarray(wmax).reshape(-1)[0])),
        _pow2(int(np.asarray(bmax).reshape(-1)[0])),
    )


def triangle_count_sparse(sh: ShardedCSR, mesh: Mesh) -> int:
    """Distributed triangle count without densification — for graphs past
    the dense ring's memory wall. Undirected semantics (symmetric simple
    adjacency; each triangle counted once); self-loops and duplicate
    entries are tolerated via candidate masking + set semantics."""
    axis, n, d, rows, width = _statics(sh)
    wmax, budget = _sparse_sizes(sh, mesh)
    f = _sparse_common_runner(
        mesh, axis, n, d, rows, width, wmax, budget, "triangles"
    )
    wrapped, approx = f(sh.indptr, sh.indices, sh.nnz_local)
    total = combine_wrapped(
        int(np.asarray(jax.device_get(wrapped)).reshape(-1)[0]),
        float(np.asarray(jax.device_get(approx)).reshape(-1)[0]),
    )
    return total // 6


def jaccard_weights_sparse(sh: ShardedCSR, mesh: Mesh):
    """Distributed per-edge Jaccard without densification ((D, width)
    padded array parallel to ``sh.indices``, pad slots 0) — the big-n
    twin of :func:`jaccard_weights`."""
    axis, n, d, rows, width = _statics(sh)
    wmax, budget = _sparse_sizes(sh, mesh)
    f = _sparse_common_runner(
        mesh, axis, n, d, rows, width, wmax, budget, "jaccard"
    )
    return f(sh.indptr, sh.indices, sh.nnz_local)


def jaccard_flat(sh: ShardedCSR, mesh: Mesh) -> np.ndarray:
    """Jaccard weights flattened to the global CSR nnz order (host
    np.float32, for parity with the single-chip feature output)."""
    padded = np.asarray(jax.device_get(jaccard_weights(sh, mesh)))
    counts = np.asarray(jax.device_get(sh.nnz_local))
    return np.concatenate([padded[i, : counts[i]] for i in range(padded.shape[0])])
