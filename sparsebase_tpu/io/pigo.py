"""PIGO-equivalent parallel readers: native mmap+OpenMP parse path.

Reference analogues: ``io::PigoMTXReader`` / ``io::PigoEdgeListReader``
(reference: src/sparsebase/io/pigo_mtx_reader.cc,
pigo_edge_list_reader.cc, vendored external/pigo/pigo.hpp). Same
semantics as the plain readers; only the body-parsing path changes to
the native fastio extension (sparsebase_tpu/io/fastio). Falls back to
the numpy path when the native library can't be built.
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import ReaderError
from . import fastio
from .edge_list import EdgeListReader
from .mtx import MTXReader


def _body_offset(filename: str) -> tuple[int, tuple]:
    """Byte offset of the first data line + the parsed size line."""
    offset = 0
    size = None
    with open(filename, "rb") as f:
        first = True
        for raw in f:
            offset += len(raw)
            line = raw.decode("ascii", "replace").strip()
            if first:
                first = False
                continue  # header
            if not line or line.startswith("%"):
                continue
            size = tuple(int(float(t)) for t in line.split())
            break
    if size is None:
        raise ReaderError("MTX file has no size line")
    return offset, size


def _fastio_enabled() -> bool:
    from ..config import get_config

    return get_config().use_fastio and fastio.available()


class PigoMTXReader(MTXReader):
    """MTXReader with the native parallel body parse."""

    def read_coo(self):
        """Coordinate bodies skip the generic float64 round trip: the
        native parser already yields int64 row/col arrays, so build the
        COO from them directly (the generic path column_stacks into a
        float64 (n,3) body and re-casts — ~3 extra GB of first-touch
        traffic at 100M nnz)."""
        opts = self.options
        if (
            not _fastio_enabled()
            or opts.format != "coordinate"
            or opts.field == "complex"
        ):
            return super().read_coo()
        from ..formats.coo import COO
        from .mtx import _value_dtype, index_dtype_for

        offset, size = _body_offset(self.filename)
        if len(size) != 3:
            raise ReaderError(f"Coordinate MTX needs 3 sizes, got {size}")
        nrows, ncols, nnz = size
        weighted = opts.field != "pattern"
        row64, col64, vals = fastio.parse_entries(self.filename, offset, weighted)
        if len(row64) != nnz:
            raise ReaderError(f"Expected {nnz} entries, found {len(row64)}")
        id_dtype = (
            np.dtype(self.id_dtype) if self.id_dtype
            else index_dtype_for(max(nrows, ncols))
        )
        row = row64.astype(id_dtype)
        col = col64.astype(id_dtype)
        if self.convert_to_zero_index:
            row -= 1
            col -= 1
        if weighted:
            vals = vals.astype(_value_dtype(opts.field, self.value_dtype))
        else:
            vals = None
        if self.upper_triangle:
            lo = np.minimum(row, col)
            hi = np.maximum(row, col)
            row, col = lo, hi
        elif opts.symmetry in ("symmetric", "skew-symmetric"):
            keep = row != col if opts.symmetry == "symmetric" else np.ones(
                row.shape, dtype=bool
            )
            row, col = (
                np.concatenate([row, col[keep]]),
                np.concatenate([col, row[keep]]),
            )
            if vals is not None:
                mirror = (
                    -vals[keep] if opts.symmetry == "skew-symmetric"
                    else vals[keep]
                )
                vals = np.concatenate([vals, mirror])
        # accumulation semantics: duplicate-coordinate payload order is
        # unobservable, so the unstable native struct sort is safe here
        return COO.new(row, col, vals, shape=(nrows, ncols), stable_payload=False)

    def _read_numeric(self):
        # complex bodies have 4 (coordinate) / 2 (array) value tokens per
        # line; the native parser handles the 2/3-column layouts only.
        if not _fastio_enabled() or self.options.field == "complex":
            return super()._read_numeric()
        offset, size = _body_offset(self.filename)
        if self.options.format == "array":
            vals = fastio.parse_values(self.filename, offset)
            return vals.reshape(-1, 1), size
        weighted = self.options.field != "pattern"
        rows, cols, vals = fastio.parse_entries(self.filename, offset, weighted)
        if weighted:
            body = np.column_stack(
                [rows.astype(np.float64), cols.astype(np.float64), vals]
            )
        else:
            body = np.column_stack([rows.astype(np.float64), cols.astype(np.float64)])
        return body, size


class PigoEdgeListReader(EdgeListReader):
    """EdgeListReader with the native parallel body parse."""

    def _load_body(self) -> np.ndarray:
        if not _fastio_enabled():
            return super()._load_body()
        try:
            rows, cols, vals = fastio.parse_entries(self.filename, 0, self.weighted)
        except OSError as e:
            raise ReaderError(str(e))
        if self.weighted:
            return np.column_stack(
                [rows.astype(np.float64), cols.astype(np.float64), vals]
            )
        return np.column_stack([rows.astype(np.float64), cols.astype(np.float64)])
