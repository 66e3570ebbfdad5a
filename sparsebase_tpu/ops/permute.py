"""Permutation ops: apply (inverse-)permutations to formats.

JAX-native analogue of the reference permute layer
(reference: src/sparsebase/permute/permuter.h:22-52,
permute_order_two.cc:30-95, permute_order_one.cc). Permutations follow
the reference convention throughout: ``order[old_id] = new_id`` (an
*inverse* permutation, reorder/reorderer.h:49-52).

The CSR row/col permutation is a fully vectorized scatter: destination
offsets are computed from the permuted indptr and per-entry in-row
offsets — no per-row loop. Columns are remapped and rows re-sorted
(the reference leaves re-sorting to the output CSR constructor,
permute_order_two.cc:86-92; here it is part of the kernel so the result
is valid under jit too).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..dispatch import Operation
from ..formats.array import DenseArray
from ..formats.base import xp_for
from ..formats.coo import COO
from ..formats.csc import CSC
from ..formats.csr import CSR
from ..formats.ell import ELL
from ..utils.exceptions import ReorderError


def inverse_permutation(order) -> object:
    """perm⁻¹: if order[old] = new, returns inv with inv[new] = old.

    Parity: ``ReorderBase::InversePermutation`` (bases/reorder_base.h).
    """
    xp = xp_for(order)
    return xp.argsort(order)


def _permute_ell(formats, params: "PermuteOrderTwoParams"):
    """Permute an ELL matrix in place of layout: the row move is ONE 2-D
    row gather (the reason ELL exists), the column relabel a masked
    gather + per-row sort."""
    ell = formats[0]
    xp = xp_for(ell.cols, ell.lens)
    out = ell
    if params.col_order is not None:
        co = xp.asarray(params.col_order)
        mask = out.valid_mask()
        new_cols = xp.where(mask, co[out.cols], 0)
        out = dataclasses.replace(out, cols=new_cols)
        out = out.sort_rows()
    if params.row_order is not None:
        out = out.permute_rows(params.row_order)
    return out


@dataclasses.dataclass
class PermuteOrderTwoParams:
    """row_order / col_order are inverse perms; None means identity
    (permute_order_two.h:12-18 parity)."""

    row_order: Optional[object] = None
    col_order: Optional[object] = None


def _permute_csr(formats, params: PermuteOrderTwoParams) -> CSR:
    """Permute rows/cols of a CSR through COO-space.

    Remap per-entry (row, col) ids by two gathers, re-sort (one stable
    argsort for row-only — column order within rows is preserved by
    stability; a two-pass lexsort when columns are remapped), rebuild
    indptr by histogram+prefix-sum. Unlike the block-move + re-sort
    formulation it needs no scatters and minimal sorts, and is
    identical in result to the reference
    (permute_order_two.cc:30-95 + the output CSR constructor's re-sort)."""
    csr: CSR = formats[0]
    xp = xp_for(csr.indptr, csr.indices)
    row_order = params.row_order
    col_order = params.col_order

    indptr, indices, vals = csr.indptr, csr.indices, csr.vals
    nrows = csr.nrows
    nnz = csr.nnz
    if row_order is None:
        new_row = csr.row_of_nnz()
        counts = indptr[1:] - indptr[:-1]
    elif xp is np:
        new_row = np.asarray(row_order)[csr.row_of_nnz()]
        counts = np.bincount(new_row, minlength=nrows)[:nrows]
    else:
        import jax.numpy as jnp

        # new_row[k] = row_order[old_row[k]] without an nnz-sized gather:
        # row_order is piecewise constant over the contiguous CSR row
        # blocks, so scatter its per-row deltas at the row-start offsets
        # and prefix-sum.
        # Empty rows stack their deltas on one slot (the add absorbs them);
        # trailing empty rows scatter out of bounds and are dropped.
        ro = xp.asarray(row_order).astype(jnp.int32)
        deltas = jnp.concatenate([ro[:1], ro[1:] - ro[:-1]])
        new_row = jnp.cumsum(
            jnp.zeros((max(nnz, 1),), jnp.int32)
            .at[indptr[:-1]]
            .add(deltas, mode="drop")
        )[:nnz].astype(indices.dtype)
        # row_order is a bijection, so the new histogram is the old row
        # degrees scattered through it — a 1M scatter, not a 16M bincount.
        counts = (
            jnp.zeros((nrows,), indptr.dtype)
            .at[ro]
            .set((indptr[1:] - indptr[:-1]).astype(indptr.dtype), mode="drop")
        )
    new_col = indices if col_order is None else xp.asarray(col_order)[indices]

    from ..convert.kernels import sort_by_pairs

    _, sorted_col, new_vals = sort_by_pairs(xp, new_row, new_col, vals)
    new_indices = sorted_col.astype(indices.dtype)
    new_indptr = xp.concatenate(
        [
            xp.zeros((1,), dtype=indptr.dtype),
            xp.cumsum(counts).astype(indptr.dtype),
        ]
    )
    return CSR(new_indptr, new_indices, new_vals, csr.shape)


def _permute_coo(formats, params: PermuteOrderTwoParams) -> COO:
    coo: COO = formats[0]
    xp = xp_for(coo.row, coo.col)
    row = coo.row if params.row_order is None else xp.asarray(params.row_order)[coo.row]
    col = coo.col if params.col_order is None else xp.asarray(params.col_order)[coo.col]
    out = COO(row.astype(coo.row.dtype), col.astype(coo.col.dtype), coo.vals, coo.shape)
    return out.sort_rowmajor()


class PermuteOrderTwo(Operation):
    """Parity: ``permute::PermuteOrderTwo`` (permute_order_two.cc)."""

    def __init__(self, row_order=None, col_order=None):
        super().__init__("permute_order_two")
        self.params = PermuteOrderTwoParams(row_order, col_order)
        self.register((CSR,), _permute_csr)
        self.register((COO,), _permute_coo)
        self.register((ELL,), _permute_ell)

    def get_permutation(self, fmt, context=None, convert_input: bool = True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)

    def get_permutation_cached(self, fmt, context=None, convert_input: bool = True):
        return self.execute_cached(
            self.params, fmt, context=context, convert_input=convert_input
        )


def _permute_array(formats, params) -> DenseArray:
    arr: DenseArray = formats[0]
    xp = xp_for(arr.vals)
    order = xp.asarray(params)
    # out[order[i]] = vals[i]  (permute_order_one.cc parity)
    return DenseArray(arr.vals[xp.argsort(order)])


class PermuteOrderOne(Operation):
    """Parity: ``permute::PermuteOrderOne`` (permute_order_one.cc)."""

    def __init__(self, order):
        super().__init__("permute_order_one")
        self.params = order
        self.register((DenseArray,), _permute_array)

    def get_permutation(self, fmt, context=None, convert_input: bool = True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


def permute_2d(fmt, row_order=None, col_order=None, context=None):
    """Functional one-shot 2-D permutation."""
    return PermuteOrderTwo(row_order, col_order).get_permutation(fmt, context)


def permute_1d(arr, order, context=None):
    """Functional one-shot 1-D permutation."""
    return PermuteOrderOne(order).get_permutation(arr, context)
