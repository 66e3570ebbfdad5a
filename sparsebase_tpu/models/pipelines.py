"""Flagship end-to-end pipelines.

The reference's "models" are its example/tutorial pipelines
(reference: examples/degree_order, examples/csr_coo, tutorials/004_cuda_spmv):
ingest → convert → reorder → permute → SpMV. These are packaged here as
jittable pytree→pytree functions — the compute-path showcase of the
framework.

The op mix keeps nnz-sized random accesses and scatters to a minimum
and prefers sorts and streaming passes (cumsum, elementwise). Which
variant is fastest on the GPU is not yet measured (ROADMAP Speed
item 3). The pipeline:

* builds ``indptr`` with the sorted-runs boundary kernel (one 1-key sort)
  instead of a histogram scatter-add;
* expands per-row values over nnz with delta-scatter + cumsum
  (piecewise-constant trick) instead of nnz-sized gathers;
* reduces the SpMV **before** the permutation sort, in source-row order
  (cumsum + indptr diffs — order-independent per-row sums), so the
  product array never rides the sort and the sort carries only
  (new_row, new_col, vals);
* fuses the two irreducible nnz-sized random gathers (column relabel
  and x-vector, both indexed by ``coo.col``) into ONE gather from an
  interleaved (n, 2) table — plus one 2-key sort.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..convert.kernels import coo_to_csr, expand_row_table, indptr_from_sorted_rows
from ..formats.coo import COO
from ..formats.csr import CSR
from ..ops.permute import PermuteOrderTwoParams, _permute_csr


def spmv_csr(csr: CSR, x, method: str = "auto"):
    """Row-wise SpMV.

    ``method``:
      * ``"cumsum"`` — inclusive prefix-sum of the per-entry products,
        row sums read off as differences at the indptr boundaries: one
        cumsum plus two n-sized gathers in place of an nnz-sized
        scatter-add. The error of a row sum scales with the magnitude of
        the running sum, not of the row.
      * ``"segment"`` — per-row ``segment_sum`` (exact per-row
        accumulation; the default on host).
      * ``"auto"`` — ``cumsum`` on device arrays, ``segment`` otherwise.
    """
    vals = csr.vals if csr.vals is not None else jnp.ones((csr.nnz,), x.dtype)
    prod = vals.astype(x.dtype) * x[csr.indices]
    if method == "auto":
        import numpy as np

        method = "segment" if isinstance(prod, np.ndarray) else "cumsum"
    if method == "cumsum":
        run = jnp.concatenate([jnp.zeros((1,), prod.dtype), jnp.cumsum(prod)])
        return run[csr.indptr[1:]] - run[csr.indptr[:-1]]
    return jax.ops.segment_sum(prod, csr.row_of_nnz(), num_segments=csr.nrows)


def _row_sums_blocked(prod, indptr, n, block: int = 512):
    """Per-row sums of the contiguous-row product stream — two-level
    blocked prefix instead of one global nnz ``cumsum``: within-block
    inclusive scans over a (B, K) reshape (vectorized, minor axis) + a
    B-sized block-prefix, with the per-row boundary reads becoming two
    n-sized gathers ``run[e] = bpfx[e // K] + intra[e - 1]``. Exactness
    matches the cumsum formulation (same f32 running sums, shorter
    chains)."""
    K = int(block)
    nnz = prod.shape[0]
    B = -(-nnz // K)
    P = B * K
    p = (
        prod
        if P == nnz
        else jnp.concatenate([prod, jnp.zeros((P - nnz,), prod.dtype)])
    )
    intra = jnp.cumsum(p.reshape(B, K), axis=1)
    bpfx = jnp.concatenate(
        [jnp.zeros((1,), prod.dtype), jnp.cumsum(intra[:, -1])]
    )
    flat_intra = intra.reshape(-1)

    def run_at(e):
        e32 = e.astype(jnp.int32)
        be = e32 // K
        head = e32 - be * K == 0
        intra_part = jnp.where(
            head, jnp.zeros((), prod.dtype), flat_intra[jnp.maximum(e32 - 1, 0)]
        )
        return bpfx[be] + intra_part

    return run_at(indptr[1:]) - run_at(indptr[:-1])


def _permute_and_spmv(
    coo: COO, indptr, degrees, ro, x, *, blocked_reduce: bool = False,
    perm=None, boundary_diff: bool = True, fused_scatter: bool = False,
    post_sort_reduce: bool = False, unique_hint: bool = False,
    perm_for_counts=None,
):
    """Shared pipeline tail: given an inverse permutation ``ro`` (and the
    CSR structure of the input), apply the symmetric permutation (one
    fused pair gather + one 2-key sort) and compute ``y = P·(A@x)``.

    Variants of the y branch, kept until the GPU picks one (ROADMAP
    Design item 3):

    * ``boundary_diff`` — read the running sum once at all n+1 indptr
      boundaries and difference (ONE n-sized gather) instead of two
      gathers at indptr[1:] / indptr[:-1].
    * ``fused_scatter`` — write (y, degrees) through ONE (n, 2) scatter
      at ``ro`` (f32 rides as int32 bits) instead of two separate
      n-sized scatters.
    * ``post_sort_reduce`` — ride x_c through the sort as a third
      payload and reduce per NEW row (cumsum + new_indptr boundary
      diff), eliminating the y scatter entirely.

    ``boundary_diff`` is the default.
    """
    n = coo.nrows
    nnz = coo.nnz
    idt = coo.row.dtype
    vals = coo.vals if coo.vals is not None else jnp.ones((nnz,), x.dtype)

    # -- the one irreducible random-access pass: pair gather ------------------
    # table[c] = (ro[c], bits(x[c])); one (n,2) lookup by coo.col replaces
    # the two separate gathers (f32 rides as int32 bits, exact)
    table = jnp.stack(
        [ro.astype(jnp.int32), jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)],
        axis=1,
    )
    pair = table[coo.col]
    new_col = pair[:, 0].astype(idt)
    x_c = jax.lax.bitcast_convert_type(pair[:, 1], jnp.float32)

    # -- permutation: relabel + one 2-key sort --------------------------------
    new_row = expand_row_table(ro, indptr, nnz, out_dtype=idt)
    if post_sort_reduce:
        _, col_s, vals_s, xbits_s = jax.lax.sort(
            (new_row, new_col, vals, pair[:, 1]), num_keys=2, is_stable=False
        )
    else:
        _, col_s, vals_s = jax.lax.sort(
            (new_row, new_col, vals), num_keys=2, is_stable=False
        )

    # -- new indptr (+ y write when fused) -----------------------------------
    if perm is not None:
        counts_new = degrees[perm]
    elif perm_for_counts is not None:
        # counts via gather on the forward permutation (one n-gather in
        # place of one n-scatter; the y write stays a scatter)
        counts_new = degrees[perm_for_counts]
    elif not (fused_scatter and perm is None and not post_sort_reduce):
        if unique_hint:
            counts_new = jnp.zeros((n,), indptr.dtype).at[ro].set(
                degrees, unique_indices=True, mode="promise_in_bounds"
            )
        else:
            counts_new = jnp.zeros((n,), indptr.dtype).at[ro].set(degrees)

    # -- SpMV, reduced per row (order-independent within a row) --------------
    if post_sort_reduce:
        # reduce in NEW row order after the sort: no y scatter at all
        new_indptr = jnp.concatenate(
            [jnp.zeros((1,), indptr.dtype),
             jnp.cumsum(counts_new).astype(indptr.dtype)]
        )
        prod = vals_s.astype(x.dtype) * jax.lax.bitcast_convert_type(
            xbits_s, jnp.float32
        ).astype(x.dtype)
        run = jnp.concatenate([jnp.zeros((1,), prod.dtype), jnp.cumsum(prod)])
        ga = run[new_indptr]
        y = ga[1:] - ga[:-1]
        permuted = CSR(new_indptr, col_s, vals_s, coo.shape)
        return permuted, y

    prod = vals.astype(x.dtype) * x_c.astype(x.dtype)
    if blocked_reduce:
        y_old = _row_sums_blocked(prod, indptr, n)
    else:
        run = jnp.concatenate([jnp.zeros((1,), prod.dtype), jnp.cumsum(prod)])
        if boundary_diff:
            ga = run[indptr]
            y_old = ga[1:] - ga[:-1]
        else:
            y_old = run[indptr[1:]] - run[indptr[:-1]]
    # perm (forward permutation) turns the n-sized scatters below into
    # gathers; callers leave perm=None until the GPU measurement of
    # ROADMAP Design item 3.
    if perm is not None:
        y = y_old[perm]  # y[new] = (A@x)[perm[new]]
        counts_out = counts_new
    elif fused_scatter:
        payload = jnp.stack(
            [jax.lax.bitcast_convert_type(y_old.astype(jnp.float32), jnp.int32),
             degrees.astype(jnp.int32)],
            axis=1,
        )
        packed = jnp.zeros((n, 2), jnp.int32).at[ro].set(payload)
        y = jax.lax.bitcast_convert_type(packed[:, 0], jnp.float32).astype(
            prod.dtype
        )
        counts_out = packed[:, 1].astype(indptr.dtype)
    elif unique_hint:
        # ro is a permutation: the scatter is collision-free by
        # construction, so tell XLA (unique_indices + in-bounds promise)
        y = jnp.zeros((n,), prod.dtype).at[ro].set(
            y_old, unique_indices=True, mode="promise_in_bounds"
        )
        counts_out = counts_new
    else:
        y = jnp.zeros((n,), prod.dtype).at[ro].set(y_old)  # y[ro[i]] = (A@x)[i]
        counts_out = counts_new
    new_indptr = jnp.concatenate(
        [jnp.zeros((1,), indptr.dtype), jnp.cumsum(counts_out).astype(indptr.dtype)]
    )
    permuted = CSR(new_indptr, col_s, vals_s, coo.shape)
    return permuted, y


def preprocess_pipeline(coo: COO, x):
    """The canonical slice (SURVEY.md §7 phase 2 / BASELINE.md configs):
    COO → CSR → degree reorder → symmetric row/col permutation → SpMV.
    Fully jittable; returns ``(permuted_csr, y)`` where ``y = P·(A@x)``
    (= the permuted matrix applied to the permuted vector).

    Parity: examples/degree_order + examples/csr_coo +
    tutorials/004_cuda_spmv of the reference, as one fused device program.
    """
    n = coo.nrows
    nnz = coo.nnz
    idt = coo.row.dtype

    # -- COO→CSR (conversion): blocked-compaction indptr ----------------------
    from ..convert.kernels import indptr_from_sorted_rows_blocked

    indptr = indptr_from_sorted_rows_blocked(coo.row, n, nnz)
    degrees = indptr[1:] - indptr[:-1]

    # -- degree reorder (counting-sort rank; DegreeReorder parity) -----------
    perm = jnp.argsort(degrees, stable=True)  # perm[new] = old
    ro = jnp.zeros((n,), idt).at[perm].set(jnp.arange(n, dtype=idt))  # ro[old]=new

    return _permute_and_spmv(coo, indptr, degrees, ro, x)


def preprocess_pipeline_v2(coo: COO, x, *, block: int = 512, blocked_reduce: bool = True):
    """Experimental variant of :func:`preprocess_pipeline` exposing the
    block size and the two-level blocked SpMV reduction in place of the
    global cumsum. Kept until the GPU measurement of ROADMAP Design
    item 3. y differs from v1 only by f32 summation association."""
    from ..convert.kernels import indptr_from_sorted_rows_blocked

    n = coo.nrows
    nnz = coo.nnz
    idt = coo.row.dtype
    indptr = indptr_from_sorted_rows_blocked(coo.row, n, nnz, block=block)
    degrees = indptr[1:] - indptr[:-1]
    perm = jnp.argsort(degrees, stable=True)
    ro = jnp.zeros((n,), idt).at[perm].set(jnp.arange(n, dtype=idt))
    return _permute_and_spmv(
        coo, indptr, degrees, ro, x, blocked_reduce=blocked_reduce
    )


def rcm_pipeline(coo: COO, x):
    """COO → CSR → device RCM (level-synchronous ``while_loop``) →
    symmetric permutation → SpMV, fully jittable — the reference's
    ``examples/rcm_order`` + tutorial 004 as one device program."""
    from ..ops.reorder.rcm import _rcm_device

    n = coo.nrows
    nnz = coo.nnz
    idt = coo.row.dtype
    indptr = indptr_from_sorted_rows(coo.row, n, nnz)
    degrees = indptr[1:] - indptr[:-1]
    csr = CSR(indptr, coo.col, coo.vals, coo.shape)
    ro = _rcm_device(csr).astype(idt)
    return _permute_and_spmv(coo, indptr, degrees, ro, x)


def partition_pipeline(coo: COO, x, k: int = 8, num_iters: int = 10):
    """COO → CSR → device label propagation → group rows by part →
    permutation → SpMV; returns ``(permuted_csr, y, labels)``. The
    partition-then-localize slice (reference: examples/metis_partition
    followed by a permute), jittable end to end."""
    import jax.numpy as _jnp

    from ..ops.partition.labelprop import PulpPartitionParams, _propagate

    n = coo.nrows
    nnz = coo.nnz
    idt = coo.row.dtype
    indptr = indptr_from_sorted_rows(coo.row, n, nnz)
    degrees = indptr[1:] - indptr[:-1]
    csr = CSR(indptr, coo.col, coo.vals, coo.shape)
    cap = 1.1 * n / k
    labels0 = (jnp.arange(n, dtype=jnp.int32) * k) // max(n, 1)
    labels = _propagate(_jnp, csr, labels0, k, cap, None, num_iters)
    # rows grouped by part, stable within a part: rank by (label, id)
    order = jnp.lexsort((jnp.arange(n), labels))  # order[new] = old
    ro = jnp.zeros((n,), idt).at[order].set(jnp.arange(n, dtype=idt))
    permuted, y = _permute_and_spmv(coo, indptr, degrees, ro, x)
    return permuted, y, labels


# Donating variant: the COO buffers are dead after the relabel/sort reads,
# so donation lets XLA reuse them for the permuted outputs instead of
# double-buffering — the analogue of the reference's move conversions
# (reference: src/sparsebase/converter/converter_order_two.cc:258-341).
# Note a donated input is consumed: callers must not reuse `coo` after.
preprocess_pipeline_donating = jax.jit(preprocess_pipeline, donate_argnums=(0,))


_SPMV_OP = None


def spmv(fmt, x, context=None):
    """Format-polymorphic SpMV with auto-conversion dispatch — the
    user-facing capstone of the reorder→format payoff (tutorial 007):
    CSR runs the cumsum/segment kernel, ELL the masked row sums, DIA
    the gather-free banded kernel, and anything else (COO, CSC, ...) auto-converts
    through the conversion graph, mirroring the reference's
    FunctionMatcherMixin dispatch (function_matcher_mixin.h:335-416)."""
    global _SPMV_OP
    if _SPMV_OP is None:
        from ..dispatch import Operation
        from ..formats.dia import DIA
        from ..formats.ell import ELL
        from ..ops.kernels import banded_spmv

        op = Operation("spmv")
        op.register((CSR,), lambda f, p: spmv_csr(f[0], p))
        op.register((ELL,), lambda f, p: spmv_ell(f[0], p))
        op.register((DIA,), lambda f, p: banded_spmv(f[0], p))
        _SPMV_OP = op
    return _SPMV_OP.execute(x, fmt, context=context)


def spmv_ell(ell, x):
    """Row-wise SpMV on the ELL (row-padded) layout: masked elementwise
    products + a row sum — no indptr machinery; the x-gather is the only
    irregular access. Pattern matrices multiply by the mask."""
    import jax.numpy as jnp

    from ..formats.base import xp_for

    xp = xp_for(ell.cols)
    mask = ell.valid_mask()
    xg = x[ell.cols]
    if ell.vals is None:
        prod = xp.where(mask, xg, 0)
    else:
        prod = xp.where(mask, ell.vals * xg, 0)
    return prod.sum(axis=1)
