"""Compressed Sparse Column format.

JAX-native analogue of the reference ``CSC<IDType,NNZType,ValueType>``
(reference: src/sparsebase/format/csc.h:28-, csc.cc). Unlike the
reference, where CSC is a conversion *sink* (no CSC→X edges registered,
SURVEY.md §2.3), here CSC is a full node in the conversion graph: CSC→COO
and CSC→CSR are registered (convert/kernels.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..utils.typing import convert_array_dtype
from .base import Format, register_format, static_field, xp_for


@register_format
@dataclasses.dataclass(frozen=True)
class CSC(Format):
    """Order-2 sparse matrix in CSC layout (row ids sorted within column)."""

    indptr: object  # (ncols+1,)
    indices: object  # (nnz,) row ids
    vals: Optional[object]
    _shape: Tuple[int, int] = static_field(default=(0, 0))

    order = 2

    @staticmethod
    def new(indptr, indices, vals=None, shape=None) -> "CSC":
        if shape is None:
            shape = (int(np.asarray(indices).max(initial=-1)) + 1, int(len(indptr)) - 1)
        return CSC(indptr, indices, vals, (int(shape[0]), int(shape[1])))

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

    def col_of_nnz(self):
        """Per-nnz column ids (see CSR.row_of_nnz for the device
        scatter+cumsum formulation rationale)."""
        xp = xp_for(self.indptr, self.indices)
        if xp is np:
            return np.repeat(
                np.arange(self.ncols, dtype=self.indices.dtype),
                np.diff(self.indptr),
            )
        import jax.numpy as jnp

        marks = jnp.zeros((max(self.nnz, 1),), jnp.int32).at[self.indptr[:-1]].add(
            1, mode="drop"
        )
        return (jnp.cumsum(marks) - 1).astype(self.indices.dtype)[: self.nnz]

    def astype(self, id_dtype=None, nnz_dtype=None, value_dtype=None) -> "CSC":
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
        xp = xp_for(self.indptr, self.indices)
        col = self.col_of_nnz()
        vals = self.vals
        if vals is None:
            vals = xp.ones((self.nnz,), dtype=xp.int8)
        dense = xp.zeros(self._shape, dtype=vals.dtype)
        if xp is np:
            np.add.at(dense, (self.indices, col), vals)
            return dense
        return dense.at[self.indices, col].add(vals)

    def __repr__(self) -> str:
        return f"CSC(shape={self._shape}, nnz={self.nnz}, context={self.context!r})"
