"""ELL (row-padded) format — the static-shape relocation path.

No direct reference analogue (the reference stops at CSR/COO/CSC); ELL
is the layout SURVEY.md §7's design mapping calls "padded/blocked CSR
... so everything is static-shape for XLA":

* row permutation is one 2-D row gather;
* column sorts are per row, not one global 2-key sort;
* entry from flat CSR costs one nnz-sized scatter, and a FULL symmetric
  permute pays a per-slot column relabel, so ELL is meant for pipelines
  that apply repeated **row** relayouts (partition grouping, block
  reorders) or ingest padded directly, and for rows of near-uniform
  degree (padding near 1). Where it pays off on the GPU is not yet
  measured.

Layout: ``cols[i, j]`` = j-th column id of row i (pad slots 0),
``vals[i, j]`` matching values (pad 0; ``None`` for pattern matrices),
``lens[i]`` = true row length. Rows whose degree exceeds the width
cannot be represented — ``csr_to_ell`` sizes the width to the max
degree by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .base import Format, register_format, static_field, xp_for


@register_format
@dataclasses.dataclass(frozen=True)
class ELL(Format):
    """Order-2 row-padded sparse matrix (ELLPACK)."""

    cols: object  # (n, W) int32 column ids; pad slots 0
    vals: Optional[object]  # (n, W) values or None (pattern)
    lens: object  # (n,) int32 true row lengths
    _shape: Tuple[int, int] = static_field(default=(0, 0))

    order = 2

    @staticmethod
    def new(cols, vals, lens, shape) -> "ELL":
        return ELL(cols, vals, lens, (int(shape[0]), int(shape[1])))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def nnz(self) -> int:
        return int(np.asarray(self.lens).sum())

    @property
    def nrows(self) -> int:
        return self._shape[0]

    @property
    def ncols(self) -> int:
        return self._shape[1]

    @property
    def value_dtype(self):
        return None if self.vals is None else self.vals.dtype

    def valid_mask(self):
        """(n, W) bool: which slots hold real entries."""
        xp = xp_for(self.cols, self.lens)
        return (
            xp.arange(self.width, dtype=self.lens.dtype)[None, :]
            < self.lens[:, None]
        )

    def permute_rows(self, order):
        """Rows relaid so new row ``order[i]`` is old row ``i`` (inverse
        permutation, package convention) — ONE 2-D row gather."""
        xp = xp_for(self.cols)
        order = xp.asarray(order)
        # perm[new] = old: invert the inverse permutation
        n = self.nrows
        perm = xp.zeros((n,), order.dtype)
        if xp is np:
            perm[np.asarray(order)] = np.arange(n, dtype=order.dtype)
        else:
            perm = perm.at[order].set(xp.arange(n, dtype=order.dtype))
        return dataclasses.replace(
            self,
            cols=self.cols[perm],
            vals=None if self.vals is None else self.vals[perm],
            lens=self.lens[perm],
        )

    def sort_rows(self):
        """Sort each row's columns ascending (CSR invariant), carrying
        values — per-row ``lax.sort``; pad slots
        keep sorting past every real column and are re-zeroed."""
        xp = xp_for(self.cols)
        mask = self.valid_mask()
        if xp is np:
            big = np.iinfo(np.int32).max
            keyed = np.where(mask, self.cols, big)
            order = np.argsort(keyed, axis=1, kind="stable")
            cols = np.take_along_axis(keyed, order, axis=1)
            cols = np.where(mask, cols, 0)
            vals = (
                None
                if self.vals is None
                else np.where(mask, np.take_along_axis(self.vals, order, axis=1), 0)
            )
            return dataclasses.replace(self, cols=cols, vals=vals)
        import jax
        import jax.numpy as jnp

        big = jnp.iinfo(jnp.int32).max
        keyed = jnp.where(mask, self.cols, big)
        payload = (
            self.vals
            if self.vals is not None
            else jnp.zeros_like(keyed)
        )
        ks, vs = jax.lax.sort((keyed, payload), dimension=1, num_keys=1,
                              is_stable=False)
        cols = jnp.where(mask, ks, 0)
        vals = None if self.vals is None else jnp.where(mask, vs, 0)
        return dataclasses.replace(self, cols=cols, vals=vals)

    def __repr__(self) -> str:
        return (
            f"ELL(shape={self._shape}, width={self.width}, nnz={self.nnz})"
        )
