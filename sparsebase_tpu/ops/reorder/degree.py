"""Degree reordering: counting-sort rows by degree.

JAX-native analogue of ``reorder::DegreeReorder``
(reference: src/sparsebase/reorder/degree_reorder.cc:20-60; params
degree_reorder.h:15-18). The reference runs a counting sort; on the
device a single stable key-sort is the natural formulation and
preserves the same stable tie order.
"""

from __future__ import annotations

import dataclasses

from ...formats.base import xp_for
from ...formats.csr import CSR
from .base import Reorderer, ranks_from_sort_keys


@dataclasses.dataclass
class DegreeReorderParams:
    ascending: bool = True


def _degree_reorder_csr(formats, params: DegreeReorderParams):
    csr: CSR = formats[0]
    xp = xp_for(csr.indptr)
    degrees = csr.indptr[1:] - csr.indptr[:-1]
    keys = degrees if params.ascending else -degrees
    return ranks_from_sort_keys(xp, keys)


class DegreeReorder(Reorderer):
    def __init__(self, ascending: bool = True):
        super().__init__("degree_reorder")
        self.params = DegreeReorderParams(ascending)
        self.register((CSR,), _degree_reorder_csr)
