"""Single-chip sparse common-neighbor kernel (chunked binary search).

The big-n tier for TriangleCount / JaccardWeights on ONE device: the
dense bf16 matmul path materializes an n×n tile (triangles.py MAX_DEVICE_DENSE_N
wall) and the flat ragged expansion materializes Σ deg(u)² slots
(jaccard.py) — both explode past ~16k vertices / skewed degrees. This
kernel is the single-chip port of the distributed sparse-ring
formulation (parallel/ring.py::_sparse_common_runner, round-4): edges
are processed in fixed-size blocks, each block expands its candidates
N(u) in C-sized chunks, and membership in N(v) is a vectorized binary
search over the global indices array — O(nnz · wmax_block · log wmax)
work in O(E_CHUNK × C_CHUNK) memory, no densification.

Reference semantics: feature/triangle_count.cc:177-205 (undirected
triples counted once; set semantics per triangles._dedup_adj),
feature/jaccard_weights_cuda.cu:70-91 (the bst loop — per directed edge
J = |∩| / |∪| with *instance* counting, matching _jaccard_host exactly).

Launch structure: the sweep is **host-chunked** — one jitted program
processes GROUP_BLOCKS edge blocks, and Python loops groups with the
output carried device-resident (per-group scalars for triangles; an
(nnz_pad,) counts buffer threaded through donation for Jaccard). This
bounds the length of one device program at the cost of one dispatch per
group; the chunk sizes are not yet measured on the GPU.

Trace notes: static shapes — edges padded to a
group multiple, candidate chunks bounded by the *block* max degree via a
traced-bound fori_loop, binary search statically unrolled to log2(wmax)
rounds; all indexing is gathers (never searchsorted).
"""

from __future__ import annotations

import functools

import numpy as np

E_CHUNK = 4096  # edges per block
C_CHUNK = 64  # candidate positions per inner chunk: low-degree graphs
# skip the wasted positions a wider tile pays at average degree ~16
GROUP_BLOCKS = 96  # edge blocks per device launch


@functools.lru_cache(maxsize=None)
def _group_runner(n, nnz, wmax, mode, nnz_pad, group_blocks=GROUP_BLOCKS):
    import jax
    import jax.numpy as jnp

    rounds = max(int(wmax).bit_length(), 1)

    def group(indptr, indices, row, out, goff):
        deg = indptr[1:] - indptr[:-1]

        def block(bi, carry):
            out, wrapped, approx = carry
            e0 = (goff + bi) * E_CHUNK
            e = e0 + jnp.arange(E_CHUNK, dtype=jnp.int32)
            ev = e < nnz
            eidx = jnp.minimum(e, nnz - 1)
            u = row[eidx]
            v = indices[eidx]
            su = indptr[u]
            du = deg[u]
            lo0 = indptr[v]
            hi0 = indptr[v + 1]
            if mode == "triangles":
                # set semantics: each distinct directed edge counted once
                # (CSR is row-major sorted, so duplicates are adjacent),
                # self-loop edges skipped — exact parity with the host
                # _dedup_adj path.
                pidx = jnp.maximum(eidx - 1, 0)
                dup = (eidx > 0) & (row[pidx] == u) & (indices[pidx] == v)
                ev = ev & ~dup & (u != v)
            block_w = jnp.max(jnp.where(ev, du, 0))
            nc = jax.lax.div(block_w + (C_CHUNK - 1), C_CHUNK)

            def chunk(ci, acc):
                t = ci * C_CHUNK + jnp.arange(C_CHUNK, dtype=jnp.int32)
                cpos = jnp.minimum(su[:, None] + t[None, :], nnz - 1)
                cand = indices[cpos]
                cva = (t[None, :] < du[:, None]) & ev[:, None]
                if mode == "triangles":
                    # candidate-side set semantics + endpoint masking
                    ppos = jnp.minimum(
                        jnp.maximum(su[:, None] + t[None, :] - 1, 0), nnz - 1
                    )
                    prev = indices[ppos]
                    cva = cva & ((t[None, :] == 0) | (prev != cand))
                    cva = cva & (cand != u[:, None]) & (cand != v[:, None])
                left = jnp.broadcast_to(lo0[:, None], cand.shape)
                right = jnp.broadcast_to(hi0[:, None], cand.shape)
                for _ in range(rounds):
                    active = left < right
                    mid = (left + right) // 2
                    mv = indices[jnp.minimum(mid, nnz - 1)]
                    go = active & (mv < cand)
                    left = jnp.where(go, mid + 1, left)
                    right = jnp.where(active & ~go, mid, right)
                found = (
                    (left < hi0[:, None])
                    & (indices[jnp.minimum(left, nnz - 1)] == cand)
                    & cva
                )
                return acc + found.sum(axis=1).astype(jnp.int32)

            counts = jax.lax.fori_loop(
                0, nc, chunk, jnp.zeros((E_CHUNK,), jnp.int32)
            )
            counts = jnp.where(ev, counts, 0)
            if mode == "triangles":
                wrapped = wrapped + jnp.sum(counts)
                approx = approx + jnp.sum(counts.astype(jnp.float32))
            else:
                out = jax.lax.dynamic_update_slice(out, counts, (e0,))
            return out, wrapped, approx

        init = (out, jnp.int32(0), jnp.float32(0.0))
        out, wrapped, approx = jax.lax.fori_loop(0, group_blocks, block, init)
        return out, wrapped, approx

    donate = (3,) if mode == "jaccard" else ()
    return jax.jit(group, donate_argnums=donate)


def _sweep(csr, mode, group_blocks=None):
    """Host-chunked sweep over all edge blocks; returns
    (out, wrapped_sum, approx_sum)."""
    import jax
    import jax.numpy as jnp

    gb = int(group_blocks or GROUP_BLOCKS)
    indptr = csr.indptr.astype(jnp.int32)
    indices = csr.indices.astype(jnp.int32)
    row = csr.row_of_nnz().astype(jnp.int32)
    deg = indptr[1:] - indptr[:-1]
    wmax = max(int(np.asarray(deg.max())) if csr.nrows else 1, 1)
    group_span = gb * E_CHUNK
    n_groups = max(-(-csr.nnz // group_span), 1)
    nnz_pad = n_groups * group_span
    run = _group_runner(csr.nrows, csr.nnz, wmax, mode, nnz_pad, gb)
    out = jnp.zeros((nnz_pad if mode == "jaccard" else 1,), jnp.int32)
    wrapped = 0
    approx = 0.0
    for g in range(n_groups):
        out, w, a = run(indptr, indices, row, out,
                        jnp.int32(g * gb))
        if mode == "triangles":
            wrapped = (wrapped + int(np.asarray(jax.device_get(w)))) % (1 << 32)
            approx += float(np.asarray(jax.device_get(a)))
    return out, wrapped, approx


def triangle_count_sparse_device(csr, directed: bool = False,
                                 group_blocks: int | None = None) -> int:
    """Undirected triangle count on one chip without densification.

    Directed 3-cycles have no per-edge common-neighbor form, so
    ``directed=True`` is rejected here and the caller falls back to
    host (the reference's directed variant is host-only semantics
    anyway, triangle_count.cc:141-175)."""
    if directed:
        raise ValueError("sparse device path is undirected-only")
    from ...utils.exact import combine_wrapped

    if csr.nnz == 0:
        return 0
    _, wrapped, approx = _sweep(csr, "triangles", group_blocks=group_blocks)
    wrapped = wrapped if wrapped < (1 << 31) else wrapped - (1 << 32)
    total = combine_wrapped(int(wrapped), float(approx))
    return total // 6


def jaccard_weights_sparse_device(csr):
    """Per-edge Jaccard weights on one chip in O(block) memory —
    numerically identical to _jaccard_host (instance counting; self
    loops kept), for graphs whose flat ragged expansion Σ deg(u)² would
    not fit."""
    import jax.numpy as jnp

    from ...utils.exact import ratio_f32

    if csr.nnz == 0:
        return jnp.zeros((0,), jnp.float32)
    out, _, _ = _sweep(csr, "jaccard")
    indptr = csr.indptr.astype(jnp.int32)
    indices = csr.indices.astype(jnp.int32)
    row = csr.row_of_nnz().astype(jnp.int32)
    deg = indptr[1:] - indptr[:-1]
    inter = out[: csr.nnz]
    union = deg[row] + deg[indices] - inter
    return ratio_f32(inter, jnp.maximum(union, 1))
