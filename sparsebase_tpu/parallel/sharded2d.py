"""2-D mesh-sharded CSR: (row-block × column-block) distribution.

Completes the collective family (SURVEY.md §2.13 names
``psum/all_gather/all_to_all/ppermute`` — and ``reduce_scatter`` is the
canonical SpMV reduction): the matrix is tiled over a 2-D mesh, x is
sharded along the column axis, every device computes its tile's partial
products, and the row sums are combined with ``jax.lax.psum_scatter``
(reduce-scatter over the interconnect) so y comes out sharded over *both* axes —
no device ever holds a replicated n-vector.

Layout (Dr × Dc mesh, axes (x, y); R rows / C cols per tile, padded):

* ``indptr``  (Dr, Dc, R+1) — per-tile local row pointers
* ``indices`` (Dr, Dc, W)   — **tile-local** column ids in [0, C)
* ``vals``    (Dr, Dc, W) or None
* ``nnz_local`` (Dr, Dc)

This is the 2-D generalization of :class:`~.sharded.ShardedCSR` (1-D
row blocks); the reference has no distributed layer at all (its only
inter-device path is a CUDA P2P memcpy, converter/converter_cuda.cu:
12-22).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..formats.base import Format, register_format, static_field
from ..formats.csr import CSR


@register_format
@dataclasses.dataclass(frozen=True)
class Sharded2DCSR(Format):
    """CSR tiled over a 2-D (row-axis × col-axis) device mesh."""

    indptr: object  # (Dr, Dc, R+1)
    indices: object  # (Dr, Dc, W) tile-local col ids
    vals: Optional[object]  # (Dr, Dc, W) or None
    nnz_local: object  # (Dr, Dc)
    _shape: Tuple[int, int] = static_field(default=(0, 0))
    _axes: Tuple[str, str] = static_field(default=("x", "y"))

    order = 2

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def axes(self) -> Tuple[str, str]:
        return self._axes

    @property
    def grid(self) -> Tuple[int, int]:
        return (int(self.indptr.shape[0]), int(self.indptr.shape[1]))

    @property
    def rows_per_tile(self) -> int:
        return int(self.indptr.shape[2]) - 1

    @property
    def nnz(self) -> int:
        return int(np.asarray(jax.device_get(self.nnz_local)).sum())

    @staticmethod
    def from_csr(csr: CSR, mesh: Mesh, axes: Tuple[str, str] = ("x", "y")) -> "Sharded2DCSR":
        """Tile a host/device CSR over the 2-D ``mesh`` (host pass)."""
        csr = csr.to_host()
        indptr = np.asarray(csr.indptr).astype(np.int64)
        indices = np.asarray(csr.indices).astype(np.int64)
        vals = None if csr.vals is None else np.asarray(csr.vals)
        n, m = csr.shape
        dr, dc = mesh.shape[axes[0]], mesh.shape[axes[1]]
        # rows per tile padded to a multiple of dc so psum_scatter tiles evenly
        rows = -(-n // dr)
        rows = -(-rows // dc) * dc
        cols = -(-m // dc)

        # split every row's entries by column block (vectorized host pass;
        # within a tile the entries keep their CSR order)
        row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        tile_r = row_of // rows
        tile_c = np.minimum(indices // cols, dc - 1)
        counts = np.zeros((dr, dc), np.int64)
        sels = {}
        for i in range(dr):
            for j in range(dc):
                sel = np.nonzero((tile_r == i) & (tile_c == j))[0]
                sels[i, j] = sel
                counts[i, j] = len(sel)

        width = max(int(counts.max()), 1)
        lp = np.zeros((dr, dc, rows + 1), np.int32)
        li = np.zeros((dr, dc, width), np.int32)
        lv = None if vals is None else np.zeros((dr, dc, width), vals.dtype)
        for (i, j), sel in sels.items():
            lens = np.bincount(row_of[sel] - i * rows, minlength=rows)
            lp[i, j, 1:] = np.cumsum(lens)
            cnt = len(sel)
            if cnt:
                li[i, j, :cnt] = indices[sel] - j * cols
                if lv is not None:
                    lv[i, j, :cnt] = vals[sel]
        sharding = NamedSharding(mesh, P(axes[0], axes[1]))
        put = lambda a: jax.device_put(a, sharding)
        return Sharded2DCSR(
            put(lp),
            put(li),
            None if lv is None else put(lv),
            put(counts.astype(np.int32)),
            (n, m),
            tuple(axes),
        )

    def __repr__(self) -> str:
        return (
            f"Sharded2DCSR(shape={self._shape}, grid={self.grid}, "
            f"rows/tile={self.rows_per_tile}, width={self.indices.shape[2]})"
        )


def _local_row_of(indptr_local, width):
    marks = jnp.zeros((width,), jnp.int32).at[indptr_local[:-1]].add(1, mode="drop")
    return jnp.cumsum(marks) - 1


@functools.lru_cache(maxsize=None)
def _spmv2d_runner(mesh, ax_r, ax_c, n, m, dr, dc, rows, cols, width):
    def body(indptr, indices, vals, nnz_local, xx):
        ip = indptr[0, 0]
        idx = indices[0, 0]
        v = vals[0, 0]
        cnt = nnz_local[0, 0]
        xl = xx[0]  # (C,) this column block's x slice
        lrow = _local_row_of(ip, width)
        valid = jnp.arange(width, dtype=jnp.int32) < cnt
        prod = jnp.where(valid, v * xl[idx], 0)
        y_part = jax.ops.segment_sum(prod, lrow, num_segments=rows)  # (R,)
        # reduce-scatter over the column axis: each of the Dc peers keeps
        # R/Dc rows of the summed result — comm R·(Dc-1)/Dc per device vs
        # R·Dc for a psum, and no replicated output
        y = jax.lax.psum_scatter(y_part, ax_c, scatter_dimension=0, tiled=True)
        return y[None, None]  # (1, 1, R/Dc)

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax_r, ax_c), P(ax_r, ax_c), P(ax_r, ax_c), P(ax_r, ax_c), P(ax_c)),
        out_specs=P(ax_r, ax_c),
    )
    return jax.jit(fn)


def spmv(sh: Sharded2DCSR, x, mesh: Mesh):
    """y = A @ x on the 2-D mesh: x sharded by column blocks, partial
    products reduced with ``psum_scatter`` so y is sharded over both axes.
    Returns the (n,) result (gathered by the caller's consumption)."""
    ax_r, ax_c = sh.axes
    n, m = sh.shape
    dr, dc = sh.grid
    rows = sh.rows_per_tile
    cols = -(-m // dc)
    width = sh.indices.shape[2]
    f = _spmv2d_runner(mesh, ax_r, ax_c, n, m, dr, dc, rows, cols, width)
    vals = sh.vals if sh.vals is not None else jnp.ones(sh.indices.shape, jnp.float32)
    xp = jnp.pad(jnp.asarray(x), (0, dc * cols - m)).reshape(dc, cols)
    y = f(sh.indptr, sh.indices, vals, sh.nnz_local, xp)
    # y: (Dr, Dc, R/Dc) — tile (i, j) holds rows [i*R + j*R/Dc, i*R + (j+1)*R/Dc),
    # so the flat (i, j, k) order is exactly ascending global row order
    return y.reshape(-1)[:n]


@functools.lru_cache(maxsize=None)
def _degrees2d_runner(mesh, ax_r, ax_c):
    def body(indptr):
        ip = indptr[0, 0]
        local = ip[1:] - ip[:-1]
        return jax.lax.psum(local, ax_c)[None, None]

    fn = shard_map(body, mesh=mesh, in_specs=(P(ax_r, ax_c),), out_specs=P(ax_r, None))
    return jax.jit(fn)


def degrees(sh: Sharded2DCSR, mesh: Mesh):
    """Per-row degree: per-tile counts psum'd over the column axis;
    result sharded over the row axis."""
    ax_r, ax_c = sh.axes
    n = sh.shape[0]
    d = _degrees2d_runner(mesh, ax_r, ax_c)(sh.indptr)
    return d.reshape(-1)[:n]
