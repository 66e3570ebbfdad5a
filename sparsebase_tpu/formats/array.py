"""Dense order-1 array format.

JAX-native analogue of the reference ``Array<ValueType>``
(reference: src/sparsebase/format/array.h:16-36). Used for permutation
vectors, feature outputs, heatmaps, and dense operands. A device-committed
or mesh-sharded :class:`DenseArray` plays the role of the reference's
``CUDAArray`` (format/cuda_array_cuda.cuh:11-) — placement is a property
of the data, not a separate class.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..utils.typing import convert_array_dtype
from .base import Format, register_format


@register_format
@dataclasses.dataclass(frozen=True)
class DenseArray(Format):
    """Order-1 dense array."""

    vals: object  # (n,)

    order = 1

    @staticmethod
    def new(vals) -> "DenseArray":
        return DenseArray(vals)

    @property
    def shape(self) -> Tuple[int]:
        return (int(self.vals.shape[0]),)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def value_dtype(self):
        return self.vals.dtype

    def astype(self, value_dtype=None, **_) -> "DenseArray":
        if value_dtype is None:
            return self
        return dataclasses.replace(self, vals=convert_array_dtype(self.vals, value_dtype))

    def __repr__(self) -> str:
        return f"DenseArray(n={self.nnz}, dtype={self.vals.dtype}, context={self.context!r})"


# Alias matching the reference class name.
Array = DenseArray
