"""Compressed Sparse Row format.

JAX-native analogue of the reference ``CSR<IDType,NNZType,ValueType>``
(reference: src/sparsebase/format/csr.h:27-60, csr.cc). Invariants match
the reference: rows delimited by ``indptr``; column indices sorted within
each row (the reference constructor validates sortedness in parallel and
sorts if needed, csr.cc:99-158 — here :func:`CSR.new` does the same with a
vectorized check + key-sort, on host via numpy or on device via XLA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logger import Logger
from ..utils.typing import convert_array_dtype
from .base import Format, register_format, static_field, xp_for

_log = Logger("CSR")


@register_format
@dataclasses.dataclass(frozen=True)
class CSR(Format):
    """Order-2 sparse matrix in CSR layout.

    ``vals is None`` encodes a pattern matrix (reference ``ValueType=void``).
    """

    indptr: object  # (nrows+1,) int
    indices: object  # (nnz,) int — column ids, sorted within each row
    vals: Optional[object]  # (nnz,) or None
    _shape: Tuple[int, int] = static_field(default=(0, 0))

    order = 2

    # -- construction --------------------------------------------------------
    @staticmethod
    def new(indptr, indices, vals=None, shape=None, *, sort: bool = True) -> "CSR":
        """Build a CSR, checking/repairing the per-row column sort invariant.

        Mirrors the reference constructor's check-and-sort behaviour
        (csr.cc:99-158); pass ``sort=False`` to skip (``ignore_sort``).
        """
        if shape is None:
            shape = (int(len(indptr)) - 1, int(np.asarray(indices).max(initial=-1)) + 1)
        shape = (int(shape[0]), int(shape[1]))
        csr = CSR(indptr, indices, vals, shape)
        if sort and not isinstance(indices, jax.core.Tracer):
            if not csr.is_sorted():
                _log.warning("CSR column array not sorted within rows; sorting.")
                csr = csr.sort_rows()
        return csr

    # -- introspection -------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self._shape[0]

    @property
    def ncols(self) -> int:
        return self._shape[1]

    @property
    def id_dtype(self):
        return self.indices.dtype

    @property
    def nnz_dtype(self):
        return self.indptr.dtype

    @property
    def value_dtype(self):
        return None if self.vals is None else self.vals.dtype

    # -- invariants ----------------------------------------------------------
    def row_of_nnz(self):
        """Expand indptr to a per-nnz row id array (CSR→COO row vector).

        Device path: scatter row-start markers + prefix sum — XLA's
        ``searchsorted`` lowers to a per-element binary-search loop; one
        scatter-add and one cumsum replace it exactly (empty rows double-mark the same
        slot, which the cumsum absorbs)."""
        xp = xp_for(self.indptr, self.indices)
        if xp is np:
            return np.repeat(
                np.arange(self.nrows, dtype=self.indices.dtype),
                np.diff(self.indptr),
            )
        import jax.numpy as jnp

        marks = jnp.zeros((max(self.nnz, 1),), jnp.int32).at[self.indptr[:-1]].add(
            1, mode="drop"
        )
        return (jnp.cumsum(marks) - 1).astype(self.indices.dtype)[: self.nnz]

    def is_sorted(self) -> bool:
        """Vectorized per-row sortedness check (csr.cc:99-158 equivalent)."""
        if self.nnz <= 1:
            return True
        xp = xp_for(self.indptr, self.indices)
        row = self.row_of_nnz()
        same_row = row[1:] == row[:-1]
        descending = self.indices[1:] < self.indices[:-1]
        return bool(~xp.any(same_row & descending))

    def sort_rows(self) -> "CSR":
        """Stable-sort column indices (and vals) within each row."""
        from ..convert.kernels import sort_by_pairs

        xp = xp_for(self.indptr, self.indices)
        _, indices, vals = sort_by_pairs(xp, self.row_of_nnz(), self.indices, self.vals)
        return dataclasses.replace(self, indices=indices, vals=vals)

    # -- cross-dtype conversion (TypeConverter analogue, csr.h:62-102) -------
    def astype(self, id_dtype=None, nnz_dtype=None, value_dtype=None) -> "CSR":
        return dataclasses.replace(
            self,
            indptr=convert_array_dtype(self.indptr, nnz_dtype) if nnz_dtype else self.indptr,
            indices=convert_array_dtype(self.indices, id_dtype) if id_dtype else self.indices,
            vals=(
                convert_array_dtype(self.vals, value_dtype)
                if (value_dtype and self.vals is not None)
                else self.vals
            ),
        )

    def to_dense(self):
        """Materialize as a dense (nrows, ncols) array (small matrices/tests)."""
        xp = xp_for(self.indptr, self.indices)
        row = self.row_of_nnz()
        vals = self.vals
        if vals is None:
            vals = xp.ones((self.nnz,), dtype=xp.int8)
        dense = xp.zeros(self._shape, dtype=vals.dtype)
        if xp is np:
            np.add.at(dense, (row, self.indices), vals)
            return dense
        return dense.at[row, self.indices].add(vals)

    def __repr__(self) -> str:
        return (
            f"CSR(shape={self._shape}, nnz={self.nnz}, "
            f"dtypes=({self.id_dtype},{self.nnz_dtype},{self.value_dtype}), "
            f"context={self.context!r})"
        )
