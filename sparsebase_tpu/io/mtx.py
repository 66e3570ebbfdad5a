"""MatrixMarket (.mtx) reader/writer.

JAX-native analogue of the reference MTX I/O
(reference: src/sparsebase/io/mtx_reader.{h,cc} — header parse :29-120,
coordinate read :380-496, array read :124-166; mtx_writer.{h,cc}).
Feature parity:

* objects: ``matrix`` (``vector`` rejected, like the reference)
* formats: ``coordinate`` and ``array``
* fields: ``pattern``, ``real``, ``double``, ``integer``, ``complex``
  (the reference accepts the ``complex`` header and keeps only the real
  column, mtx_reader.cc:78-80,170; here both columns are parsed — the
  real part is kept by default (device pipelines are real-valued), or pass
  a complex ``value_dtype`` (e.g. ``complex128``) to retain both parts)
* symmetries: ``general``, ``symmetric``, ``skew-symmetric``
  (``hermitian`` rejected); symmetric expansion mirrors off-diagonal
  entries, skew mirrors with negated values (mtx_reader.cc:430-486)
* ``convert_to_zero_index`` flag; ``upper_triangle`` flag folds each entry
  to (min,max) without expansion (mtx_reader.cc:380-403)

The parse path is vectorized numpy (np.loadtxt C fast-path) rather than a
scalar ``fin >>`` loop — the PIGO-parallel analogue lives in
io/fastio (native C++ parser) when built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..formats.array import DenseArray
from ..formats.coo import COO
from ..formats.csr import CSR
from ..utils.exceptions import ReaderError, WriterError
from ..utils.typing import index_dtype_for

_FIELDS = ("real", "double", "complex", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclasses.dataclass
class _MTXOptions:
    object: str
    format: str
    field: str
    symmetry: str


def _parse_header(line: str) -> _MTXOptions:
    """Parse ``%%MatrixMarket object format field symmetry``
    (mtx_reader.cc:29-120 parity, same rejections)."""
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise ReaderError(f"Invalid MatrixMarket header: {line.strip()!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:5])
    if obj == "vector":
        raise ReaderError("Library does not support reading vectors from MTX files")
    if obj != "matrix":
        raise ReaderError(f"Unknown MTX object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise ReaderError(f"Unknown MTX format {fmt!r}")
    if field not in _FIELDS:
        raise ReaderError(f"Unknown MTX field {field!r}")
    if symmetry == "hermitian":
        raise ReaderError("Library does not support hermitian MTX files")
    if symmetry not in _SYMMETRIES:
        raise ReaderError(f"Unknown MTX symmetry {symmetry!r}")
    return _MTXOptions(obj, fmt, field, symmetry)


def _value_dtype(field: str, requested):
    if requested is not None:
        return np.dtype(requested)
    return np.dtype(np.int64) if field == "integer" else np.dtype(np.float32)


def _combine_complex(re: np.ndarray, im: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Complex-field values: full complex when a complex dtype is
    requested, otherwise the real part (device pipelines are real)."""
    if dtype.kind == "c":
        return (re + 1j * im).astype(dtype)
    return re.astype(dtype)


class MTXReader:
    """Reads .mtx files into COO/CSR/DenseArray.

    Parity: ``io::MTXReader`` (mtx_reader.h:14-60). ``value_dtype=None``
    with a pattern file yields ``vals=None`` (ValueType=void analogue).
    """

    def __init__(
        self,
        filename: str,
        convert_to_zero_index: bool = True,
        upper_triangle: bool = False,
        id_dtype=None,
        value_dtype=None,
    ):
        self.filename = filename
        self.convert_to_zero_index = convert_to_zero_index
        self.upper_triangle = upper_triangle
        self.id_dtype = id_dtype
        self.value_dtype = value_dtype
        with open(filename, "r") as f:
            self.options = _parse_header(f.readline())

    # -- internals -----------------------------------------------------------
    def _read_numeric(self) -> Tuple[np.ndarray, Tuple[int, ...]]:
        """Return (body matrix as float64 2-D, size-line tuple)."""
        with open(self.filename, "r") as f:
            f.readline()  # header
            skip = 1
            for line in f:
                skip += 1
                s = line.strip()
                if s and not s.startswith("%"):
                    size = tuple(int(x) for x in s.split())
                    break
            else:
                raise ReaderError("MTX file has no size line")
        body = np.loadtxt(
            self.filename, comments="%", skiprows=skip, dtype=np.float64, ndmin=2
        )
        if body.size == 0:
            body = body.reshape(0, 3 if self.options.format == "coordinate" else 1)
        return body, size

    def read_coo(self) -> COO:
        opts = self.options
        if opts.format == "array":
            return self._read_array_into_coo()
        body, size = self._read_numeric()
        if len(size) != 3:
            raise ReaderError(f"Coordinate MTX needs 3 sizes, got {size}")
        nrows, ncols, nnz = size
        if body.shape[0] != nnz:
            raise ReaderError(f"Expected {nnz} entries, found {body.shape[0]}")
        weighted = opts.field != "pattern"
        if weighted and body.shape[1] < 3:
            raise ReaderError("Weighted MTX file lacks a value column")
        if opts.field == "complex" and body.shape[1] < 4:
            raise ReaderError("Complex MTX file lacks an imaginary column")
        id_dtype = np.dtype(self.id_dtype) if self.id_dtype else index_dtype_for(max(nrows, ncols))
        row = body[:, 0].astype(id_dtype)
        col = body[:, 1].astype(id_dtype)
        if self.convert_to_zero_index:
            row -= 1
            col -= 1
        if not weighted:
            vals = None
        elif opts.field == "complex":
            vals = _combine_complex(
                body[:, 2], body[:, 3], _value_dtype(opts.field, self.value_dtype)
            )
        else:
            vals = body[:, 2].astype(_value_dtype(opts.field, self.value_dtype))

        if self.upper_triangle:
            # fold to (min, max) per entry, no expansion (mtx_reader.cc:380-403)
            lo = np.minimum(row, col)
            hi = np.maximum(row, col)
            row, col = lo, hi
        elif opts.symmetry in ("symmetric", "skew-symmetric"):
            if opts.symmetry == "symmetric":
                keep = row != col  # mirror off-diagonal only
            else:
                keep = np.ones(row.shape, dtype=bool)
            mrow = np.concatenate([row, col[keep]])
            mcol = np.concatenate([col, row[keep]])
            if vals is not None:
                mirror = -vals[keep] if opts.symmetry == "skew-symmetric" else vals[keep]
                vals = np.concatenate([vals, mirror])
            row, col = mrow, mcol
        return COO.new(row, col, vals, shape=(nrows, ncols))

    def _read_array_into_coo(self) -> COO:
        """Dense 'array' body → COO of its nonzeros, column-major order
        (mtx_reader.cc:124-166: keeps only w != 0)."""
        if self.options.field == "pattern":
            raise ReaderError("Array-format MTX cannot be pattern")
        if self.options.symmetry != "general":
            raise ReaderError(
                "Library does not support reading array files that are "
                "symmetric, skew-symmetric, or hermitian"
            )
        body, size = self._read_numeric()
        if len(size) != 2:
            raise ReaderError(f"Array MTX needs 2 sizes, got {size}")
        nrows, ncols = size
        flat = self._array_body_values(body, nrows * ncols)
        keep = flat != 0
        idx = np.nonzero(keep)[0]
        id_dtype = np.dtype(self.id_dtype) if self.id_dtype else index_dtype_for(max(nrows, ncols))
        row = (idx % nrows).astype(id_dtype)
        col = (idx // nrows).astype(id_dtype)
        vals = flat[keep]
        return COO.new(row, col, vals, shape=(nrows, ncols))

    def _array_body_values(self, body: np.ndarray, expected: Optional[int]) -> np.ndarray:
        """Flatten an array-format body to the value vector, combining the
        two-column complex body (re, im per line) when field == complex."""
        dtype = _value_dtype(self.options.field, self.value_dtype)
        if self.options.field == "complex":
            flat = body.reshape(-1)
            if flat.shape[0] % 2 != 0:
                raise ReaderError("Complex array MTX body has an odd token count")
            pairs = flat.reshape(-1, 2)
            vals = _combine_complex(pairs[:, 0], pairs[:, 1], dtype)
        else:
            vals = body.reshape(-1).astype(dtype)
        if expected is not None and vals.shape[0] != expected:
            raise ReaderError(f"Expected {expected} values, found {vals.shape[0]}")
        return vals

    def read_csr(self) -> CSR:
        """ReadCOO + conversion (mtx_reader.cc:573-579 parity)."""
        from ..convert import coo_to_csr

        return coo_to_csr(self.read_coo())

    def read_array(self) -> DenseArray:
        """Read an array-format file (or single-column coordinate) as a
        dense 1-D array (mtx_reader.cc ReadArrayIntoArray)."""
        if self.options.field == "pattern":
            raise ReaderError("Cannot read a pattern MTX into a value array")
        if self.options.format == "array":
            body, size = self._read_numeric()
            expected = int(np.prod(size)) if len(size) == 2 else None
            return DenseArray.new(self._array_body_values(body, expected))
        coo = self.read_coo()
        dense = np.asarray(coo.to_dense()).reshape(-1)
        return DenseArray.new(dense.astype(_value_dtype(self.options.field, self.value_dtype)))


class MTXWriter:
    """Writes COO/CSR/DenseArray to .mtx.

    Parity: ``io::MTXWriter`` (mtx_writer.h:16-40) including header
    options (object/format/field/symmetry). Symmetric output keeps only
    the lower triangle, matching MatrixMarket conventions.
    """

    def __init__(
        self,
        filename: str,
        object: str = "matrix",
        format: str = "coordinate",
        field: str = "real",
        symmetry: str = "general",
    ):
        self.filename = filename
        if object not in ("matrix",):
            raise WriterError(f"Unsupported MTX object {object!r}")
        if format not in ("coordinate", "array"):
            raise WriterError(f"Unsupported MTX format {format!r}")
        if field not in _FIELDS:
            raise WriterError(f"Unknown MTX field {field!r}")
        if symmetry == "hermitian":
            raise WriterError("Hermitian MTX writing is not supported")
        if symmetry not in _SYMMETRIES:
            raise WriterError(f"Unknown MTX symmetry {symmetry!r}")
        self.object = object
        self.format = format
        self.field = field
        self.symmetry = symmetry

    def _header(self) -> str:
        return f"%%MatrixMarket {self.object} {self.format} {self.field} {self.symmetry}\n"

    def _fmt_val(self, v) -> str:
        if self.field == "integer":
            return str(int(v))
        if self.field == "complex":
            c = complex(v)
            return f"{c.real!r} {c.imag!r}"
        return repr(float(v))

    def write_coo(self, coo: COO) -> None:
        coo = coo.to_host()
        row = np.asarray(coo.row)
        col = np.asarray(coo.col)
        vals = None if coo.vals is None else np.asarray(coo.vals)
        if self.field == "pattern":
            vals = None
        elif vals is None:
            raise WriterError("Cannot write pattern matrix with a value field; use field='pattern'")
        if self.format == "array":
            dense = np.asarray(coo.to_dense())
            with open(self.filename, "w") as f:
                f.write(self._header())
                f.write(f"{coo.nrows} {coo.ncols}\n")
                for v in dense.T.reshape(-1):  # column-major
                    f.write(self._fmt_val(v) + "\n")
            return
        if self.symmetry in ("symmetric", "skew-symmetric"):
            keep = row >= col  # store lower triangle
            row, col = row[keep], col[keep]
            if vals is not None:
                vals = vals[keep]
        with open(self.filename, "w") as f:
            f.write(self._header())
            f.write(f"{coo.nrows} {coo.ncols} {row.shape[0]}\n")
            if vals is None:
                for r, c in zip(row, col):
                    f.write(f"{int(r) + 1} {int(c) + 1}\n")
            else:
                for r, c, v in zip(row, col, vals):
                    f.write(f"{int(r) + 1} {int(c) + 1} {self._fmt_val(v)}\n")

    def write_csr(self, csr: CSR) -> None:
        from ..convert import csr_to_coo

        self.write_coo(csr_to_coo(csr.to_host()))

    def write_array(self, arr: DenseArray) -> None:
        if self.field == "pattern":
            raise WriterError("Cannot write a value array as pattern")
        vals = np.asarray(arr.to_host().vals)
        with open(self.filename, "w") as f:
            f.write(f"%%MatrixMarket matrix array {self.field} general\n")
            f.write(f"{vals.shape[0]} 1\n")
            for v in vals:
                f.write(self._fmt_val(v) + "\n")
