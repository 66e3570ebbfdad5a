"""Coordinate (triplet) format.

JAX-native analogue of the reference ``COO<IDType,NNZType,ValueType>``
(reference: src/sparsebase/format/coo.h:26-, coo.cc). Invariant matches
the reference: entries sorted row-major by (row, col) — the reference
constructor checks and sorts (coo.cc:112-140); here :func:`COO.new` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np

from ..utils.logger import Logger
from ..utils.typing import convert_array_dtype
from .base import Format, register_format, static_field, xp_for

_log = Logger("COO")


@register_format
@dataclasses.dataclass(frozen=True)
class COO(Format):
    """Order-2 sparse matrix as (row, col, val) triplets, row-major sorted."""

    row: object  # (nnz,)
    col: object  # (nnz,)
    vals: Optional[object]  # (nnz,) or None
    _shape: Tuple[int, int] = static_field(default=(0, 0))

    order = 2

    @staticmethod
    def new(
        row, col, vals=None, shape=None, *, sort: bool = True,
        stable_payload: bool = True,
    ) -> "COO":
        if shape is None:
            shape = (
                int(np.asarray(row).max(initial=-1)) + 1,
                int(np.asarray(col).max(initial=-1)) + 1,
            )
        shape = (int(shape[0]), int(shape[1]))
        coo = COO(row, col, vals, shape)
        if sort and not isinstance(row, jax.core.Tracer):
            if not coo.is_sorted():
                _log.warning("COO arrays not sorted row-major; sorting.")
                coo = coo.sort_rowmajor(stable_payload=stable_payload)
        return coo

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def nrows(self) -> int:
        return self._shape[0]

    @property
    def ncols(self) -> int:
        return self._shape[1]

    @property
    def id_dtype(self):
        return self.row.dtype

    @property
    def value_dtype(self):
        return None if self.vals is None else self.vals.dtype

    def is_sorted(self) -> bool:
        if self.nnz <= 1:
            return True
        xp = xp_for(self.row, self.col)
        r0, r1 = self.row[:-1], self.row[1:]
        c0, c1 = self.col[:-1], self.col[1:]
        ok = (r1 > r0) | ((r1 == r0) & (c1 >= c0))
        return bool(xp.all(ok))

    def sort_rowmajor(self, stable_payload: bool = True) -> "COO":
        # stable_payload=False: readers/ingest (accumulation semantics)
        # unlock the native weighted struct sort — duplicate-coordinate
        # payload order is unobservable once accumulated
        from ..convert.kernels import sort_by_pairs

        xp = xp_for(self.row, self.col)
        row, col, vals = sort_by_pairs(
            xp, self.row, self.col, self.vals, stable_payload=stable_payload
        )
        return dataclasses.replace(self, row=row, col=col, vals=vals)

    def astype(self, id_dtype=None, nnz_dtype=None, value_dtype=None) -> "COO":
        # nnz_dtype unused: COO carries no offset array (parity with
        # reference TypeConverter for COO, format/coo.h).
        return dataclasses.replace(
            self,
            row=convert_array_dtype(self.row, id_dtype) if id_dtype else self.row,
            col=convert_array_dtype(self.col, id_dtype) if id_dtype else self.col,
            vals=(
                convert_array_dtype(self.vals, value_dtype)
                if (value_dtype and self.vals is not None)
                else self.vals
            ),
        )

    def to_dense(self):
        xp = xp_for(self.row, self.col)
        vals = self.vals
        if vals is None:
            vals = xp.ones((self.nnz,), dtype=xp.int8)
        dense = xp.zeros(self._shape, dtype=vals.dtype)
        if xp is np:
            np.add.at(dense, (self.row, self.col), vals)
            return dense
        return dense.at[self.row, self.col].add(vals)

    def __repr__(self) -> str:
        return f"COO(shape={self._shape}, nnz={self.nnz}, context={self.context!r})"
