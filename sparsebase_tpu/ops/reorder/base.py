"""Reorderer base: ops producing inverse permutations.

JAX-native analogue of the reference reorder layer
(reference: src/sparsebase/reorder/reorderer.h:37-118). Every reorderer
returns an **inverse permutation** array ``order[old_id] = new_id``
(reorderer.h:49-52), as a host numpy or device jax array matching the
input placement.
"""

from __future__ import annotations

from typing import Any, Optional

from ...context import Context
from ...dispatch import Operation
from ...formats.base import Format


class Reorderer(Operation):
    """Base class; subclasses register per-format implementations in their
    constructor (e.g. rcm_reorder.cc:9-13 pattern) and set ``self.params``.
    """

    params: Any = None

    def get_reorder(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ):
        """Compute the inverse permutation (GetReorder, reorderer.h:57-76)."""
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)

    def get_reorder_cached(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ):
        """Also returns converted intermediates (GetReorderCached)."""
        return self.execute_cached(
            self.params, fmt, context=context, convert_input=convert_input
        )


def ranks_from_sort_keys(xp, keys) -> object:
    """inverse permutation placing items in ascending-key order:
    rank[v] = position of v after a stable sort of keys."""
    perm = xp.argsort(keys, stable=True)  # perm[new] = old
    n = keys.shape[0]
    inv = xp.zeros((n,), dtype=perm.dtype)
    if xp.__name__ == "numpy":
        inv[perm] = xp.arange(n, dtype=perm.dtype)
    else:
        inv = inv.at[perm].set(xp.arange(n, dtype=perm.dtype))
    return inv
