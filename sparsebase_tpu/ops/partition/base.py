"""Partitioner base: ops producing vertex→part labels.

JAX-native analogue of the reference partition layer
(reference: src/sparsebase/partition/partitioner.h:23-36). Every
partitioner returns ``part[vertex] = part_id`` with labels in
``[0, num_partitions)``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ...context import Context
from ...dispatch import Operation
from ...formats.base import Format, xp_for
from ...formats.csr import CSR


class Partitioner(Operation):
    params: Any = None

    def partition(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ):
        """Compute vertex→part labels (Partitioner::Partition)."""
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


def edge_cut(csr: CSR, labels) -> int:
    """Number of edges crossing partitions (counts each direction once in a
    symmetric matrix: total/2)."""
    xp = xp_for(csr.indptr, csr.indices)
    labels = xp.asarray(labels)
    row = csr.row_of_nnz()
    cut = (labels[row] != labels[csr.indices]).sum()
    return int(cut) // 2


def part_sizes(labels, num_parts: int, weights=None):
    xp = xp_for(labels)
    if xp is np:
        return np.bincount(labels, weights=weights, minlength=num_parts)[:num_parts]
    import jax.numpy as jnp

    return jnp.bincount(labels, weights=weights, length=num_parts)


def balance_ratio(labels, num_parts: int) -> float:
    """max part size / ideal size."""
    sizes = np.asarray(part_sizes(np.asarray(labels), num_parts))
    return float(sizes.max() * num_parts / max(labels.shape[0], 1))
