"""DIA (diagonal) format — the banded-matrix container.

No direct reference analogue (the reference stops at CSR/COO/CSC); DIA
is the natural device target for matrices *after* bandwidth-reducing
reordering (RCM): storage is dense per diagonal, so SpMV needs no
gathers or scatters at all — it runs as shifted elementwise
multiply-adds (see ops/kernels/banded_spmv.py).

Layout: ``data[d, i] = A[i, i + offsets[d]]`` (zero where out of range),
offsets sorted ascending.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..utils.typing import convert_array_dtype
from .base import Format, register_format, static_field, xp_for


@register_format
@dataclasses.dataclass(frozen=True)
class DIA(Format):
    """Order-2 banded matrix as dense diagonals."""

    offsets: object  # (k,) int32, sorted; offset = col - row
    data: object  # (k, nrows) values
    _shape: Tuple[int, int] = static_field(default=(0, 0))

    order = 2

    @staticmethod
    def new(offsets, data, shape) -> "DIA":
        return DIA(offsets, data, (int(shape[0]), int(shape[1])))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        """Count of stored nonzeros (explicit zeros in the band excluded)."""
        return int(np.asarray((np.asarray(self.data) != 0).sum()))

    @property
    def num_diagonals(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def bandwidth(self) -> int:
        offs = np.asarray(self.offsets)
        return int(np.abs(offs).max(initial=0))

    @property
    def value_dtype(self):
        return self.data.dtype

    def astype(self, value_dtype=None, **_) -> "DIA":
        if value_dtype is None:
            return self
        return dataclasses.replace(self, data=convert_array_dtype(self.data, value_dtype))

    def to_dense(self):
        xp = xp_for(self.offsets, self.data)
        n, m = self._shape
        dense = xp.zeros((n, m), dtype=self.data.dtype)
        offs = np.asarray(self.offsets)
        data = self.data
        for d, off in enumerate(offs.tolist()):
            i = np.arange(n)
            j = i + off
            ok = (j >= 0) & (j < m)
            if xp is np:
                dense[i[ok], j[ok]] = np.asarray(data)[d, i[ok]]
            else:
                dense = dense.at[i[ok], j[ok]].set(data[d, i[ok]])
        return dense

    def __repr__(self) -> str:
        return (
            f"DIA(shape={self._shape}, diagonals={self.num_diagonals}, "
            f"bandwidth={self.bandwidth}, context={self.context!r})"
        )
