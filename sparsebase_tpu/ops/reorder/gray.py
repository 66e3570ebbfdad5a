"""Gray-code reordering.

JAX-native redesign of ``reorder::GrayReorder``
(reference: src/sparsebase/reorder/gray_reorder.cc, 429 LoC; params
gray_reorder.h:13-28). Semantics preserved:

* rows split sparse/dense by ``nnz_threshold`` (gray_reorder.cc:149-170)
* bandedness checks: sparse sub-matrix "banded" if >30% of its nnz lie
  within ``ncols/128`` of the diagonal → only degree-sort it; dense
  banded if >20% → keep its original order (gray_reorder.cc:178-190)
* per-row occupancy bitmap over ``resolution`` column blocks; bit j set
  when the block's nnz count exceeds a threshold (0 for sparse rows,
  ``degree // resolution`` for dense rows); the sort key is the
  **Gray-decoded** bitmap (``grey_bin_to_dec``, a suffix-XOR)
* sparse rows: degree-sorted, then chunks of ``sparse_density_group_size``
  distinct-degree groups are sorted by key with alternating
  ascending/descending direction (gray_reorder.cc:283-330)
* dense rows: one ascending key sort (gray_reorder.cc:371-407)

The scalar per-row/per-bit loops of the reference become one fused
vectorized pass: per-nnz block histogram (scatter-add), thresholding,
suffix-XOR via flip→cumsum(mod 2)→flip, packing 64 key bits into two
int32 words, and a single lexsort — identical keys, no Python loops,
runs on host numpy or on device under jit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.base import xp_for
from ...formats.csr import CSR
from ...utils.logger import Logger
from .base import Reorderer

_log = Logger("GrayReorder")


@dataclasses.dataclass
class GrayReorderParams:
    resolution: int = 32  # bitmap width (16/32/64)
    nnz_threshold: int = 8
    sparse_density_group_size: int = 8


def _segment_bincount(xp, seg_ids, length, weights=None):
    if xp is np:
        return np.bincount(seg_ids, weights=weights, minlength=length)[:length]
    import jax.numpy as jnp

    return jnp.bincount(seg_ids, weights=weights, length=length)


def _gray_keys(xp, csr: CSR, resolution: int, per_row_threshold):
    """(high, low) int32 words of the gray-decoded occupancy bitmap."""
    n, ncols = csr.shape
    res = min(resolution, ncols)
    row_split = max(ncols // res, 1)
    row = csr.row_of_nnz()
    block = xp.minimum(csr.indices // row_split, res - 1)
    # per (row, block) histogram
    if xp is np:
        flat = row.astype(np.int64) * res + block.astype(np.int64)
        counts = _segment_bincount(xp, flat, n * res).reshape(n, res)
    else:
        # 2-D scatter-add avoids wide fused keys (no int64 on device)
        counts = xp.zeros((n, res), xp.int32).at[row, block].add(1)
    bits = counts > per_row_threshold[:, None]  # bit j = block j occupied
    # gray decode: decoded_j = XOR of gray bits k >= j  == suffix parity
    suffix = xp.cumsum(bits[:, ::-1].astype(xp.int32), axis=1)[:, ::-1] % 2
    # bit j has significance 2^j: pack into two int32 words
    j = xp.arange(res)
    low_mask, high_mask = j < 31, (j >= 31) & (j < 62)
    # per-word sums stay under 2^31 (bits 0..30 each): int32-safe on device
    weights_low = xp.where(low_mask, 1 << xp.minimum(j, 30), 0).astype(xp.int32)
    weights_high = xp.where(high_mask, 1 << xp.minimum(xp.maximum(j - 31, 0), 30), 0).astype(
        xp.int32
    )
    low = (suffix * weights_low[None, :]).sum(axis=1).astype(xp.int32)
    high = (suffix * weights_high[None, :]).sum(axis=1).astype(xp.int32)
    return high, low


def _banded_fraction(xp, csr: CSR, mask_rows, band_size):
    """Fraction of the masked rows' nnz within band of the diagonal."""
    row = csr.row_of_nnz()
    in_rows = mask_rows[row]
    in_band = xp.abs(csr.indices.astype(xp.int64) - row.astype(xp.int64)) <= band_size
    total = xp.maximum(in_rows.sum(), 1)
    return (in_rows & in_band).sum() / total


def _dense_rank(xp, values):
    """rank of each value among sorted distinct values."""
    if xp is np:
        _, inv = np.unique(values, return_inverse=True)
        return inv
    import jax.numpy as jnp

    sorted_v = jnp.sort(values)
    distinct = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_v[1:] != sorted_v[:-1]]
    )
    # rank of value v = number of distinct values strictly below v
    distinct_count = jnp.cumsum(distinct) - 1
    return distinct_count[jnp.searchsorted(sorted_v, values)]


def _gray_impl(formats, params: GrayReorderParams):
    csr: CSR = formats[0]
    xp = xp_for(csr.indptr, csr.indices)
    n, ncols = csr.shape
    degrees = (csr.indptr[1:] - csr.indptr[:-1]).astype(xp.int64)
    sparse_mask = degrees <= params.nnz_threshold

    band_size = max(ncols // 128, 1)
    sparse_banded = _banded_fraction(xp, csr, sparse_mask, band_size) > 0.3
    dense_banded = _banded_fraction(xp, csr, ~sparse_mask, band_size) > 0.2

    res = min(params.resolution, ncols)
    # thresholds: sparse rows 0, dense rows degree // resolution
    thr = xp.where(sparse_mask, 0, degrees // res)
    high, low = _gray_keys(xp, csr, params.resolution, thr)

    # -- sparse keys: chunked alternating gray order -------------------------
    # The reference degree-sorts sparse rows, then re-sorts every chunk of
    # `sparse_density_group_size` distinct-degree groups purely by gray key
    # (gray_reorder.cc:283-330) — degree order inside a chunk is destroyed.
    # Empty rows are skipped entirely (stay first, in id order) and do not
    # count as a distinct-degree group.
    MAX31 = (1 << 31) - 1
    group = _dense_rank(xp, degrees)  # distinct-degree group per row
    has_empty = (degrees == 0).any()
    group = xp.where(degrees > 0, group - has_empty.astype(group.dtype), -1)
    chunk = xp.where(group >= 0, group // max(params.sparse_density_group_size, 1), -1)
    odd = (chunk % 2 == 1) & (chunk >= 0)
    s_high = xp.where(odd, MAX31 - high, high)
    s_low = xp.where(odd, MAX31 - low, low)
    # empty rows: keep id order at the front of the sparse block
    s_high = xp.where(chunk < 0, 0, s_high)
    s_low = xp.where(chunk < 0, 0, s_low)
    # banded sub-matrices keep plain degree order (trace-safe masking)
    s_high = xp.where(sparse_banded, 0, s_high)
    s_low = xp.where(sparse_banded, 0, s_low)
    s_chunk = xp.where(sparse_banded, group, chunk)

    # -- dense keys: plain ascending gray order ------------------------------
    d_high = xp.where(dense_banded, 0, high)
    d_low = xp.where(dense_banded, 0, low)

    # compose one global lexsort:
    #   primary: dense-after-sparse
    #   sparse:  (chunk, ±gray), id on ties
    #   dense:   (gray asc), id on ties
    part = (~sparse_mask).astype(xp.int32)
    key_chunk = xp.where(sparse_mask, s_chunk, 0)
    key_high = xp.where(sparse_mask, s_high, d_high)
    key_low = xp.where(sparse_mask, s_low, d_low)
    ids = xp.arange(n)
    perm = xp.lexsort((ids, key_low, key_high, key_chunk, part))  # perm[new] = old
    inv = xp.zeros((n,), dtype=csr.indices.dtype)
    if xp is np:
        inv[perm] = np.arange(n, dtype=inv.dtype)
    else:
        inv = inv.at[perm].set(xp.arange(n, dtype=inv.dtype))
    return inv


class GrayReorder(Reorderer):
    def __init__(
        self,
        resolution: int = 32,
        nnz_threshold: int = 8,
        sparse_density_group_size: int = 8,
    ):
        super().__init__("gray_reorder")
        self.params = GrayReorderParams(resolution, nnz_threshold, sparse_density_group_size)
        self.register((CSR,), _gray_impl)
