"""Edge-list reader/writer.

JAX-native analogue of the reference edge-list I/O
(reference: src/sparsebase/io/edge_list_reader.{h,cc} — options
edge_list_reader.h:34-40; edge_list_writer.cc). Vectorized numpy parse
replaces the per-line scalar loop.
"""

from __future__ import annotations

import numpy as np

from ..formats.coo import COO
from ..formats.csr import CSR
from ..utils.exceptions import ReaderError
from ..utils.typing import index_dtype_for


class EdgeListReader:
    """Reads text edge lists: ``u v [w]`` per line.

    Parity: ``io::EdgeListReader`` (edge_list_reader.h:22-48) —
    ``weighted``, ``remove_duplicates``, ``remove_self_edges``,
    ``read_undirected`` (adds (v,u) for every (u,v)), ``square`` (force a
    square shape spanning both id ranges; the reference always emits a
    square n×n matrix where n = max id + 1, and so do we).
    """

    def __init__(
        self,
        filename: str,
        weighted: bool = False,
        remove_duplicates: bool = False,
        remove_self_edges: bool = False,
        read_undirected: bool = True,
        square: bool = False,
        id_dtype=None,
        value_dtype=np.float32,
    ):
        self.filename = filename
        self.weighted = weighted
        self.remove_duplicates = remove_duplicates
        self.remove_self_edges = remove_self_edges
        self.read_undirected = read_undirected
        self.square = square
        self.id_dtype = id_dtype
        self.value_dtype = value_dtype

    def _load_body(self) -> np.ndarray:
        try:
            return np.loadtxt(
                self.filename, comments=("%", "#"), dtype=np.float64, ndmin=2
            )
        except (OSError, ValueError) as e:
            raise ReaderError(f"Cannot read edge list {self.filename}: {e}")

    def read_coo(self) -> COO:
        body = self._load_body()
        if body.size == 0:
            body = body.reshape(0, 3 if self.weighted else 2)
        if self.weighted and body.shape[1] < 3:
            raise ReaderError("weighted=True but file has no weight column")
        n_ids = int(body[:, :2].max(initial=-1)) + 1
        id_dtype = np.dtype(self.id_dtype) if self.id_dtype else index_dtype_for(n_ids)
        row = body[:, 0].astype(id_dtype)
        col = body[:, 1].astype(id_dtype)
        vals = body[:, 2].astype(self.value_dtype) if self.weighted else None

        if self.remove_self_edges:
            keep = row != col
            row, col = row[keep], col[keep]
            if vals is not None:
                vals = vals[keep]
        if self.read_undirected:
            row, col = np.concatenate([row, col]), np.concatenate([col, row])
            if vals is not None:
                vals = np.concatenate([vals, vals])
        if self.remove_duplicates:
            pairs = np.stack([row, col], axis=1)
            _, idx = np.unique(pairs, axis=0, return_index=True)
            idx.sort()
            row, col = row[idx], col[idx]
            if vals is not None:
                vals = vals[idx]
        n = int(max(row.max(initial=-1), col.max(initial=-1))) + 1
        return COO.new(row, col, vals, shape=(n, n))

    def read_csr(self) -> CSR:
        from ..convert import coo_to_csr

        return coo_to_csr(self.read_coo())


class EdgeListWriter:
    """Writes COO/CSR as a text edge list (edge_list_writer.cc parity)."""

    def __init__(self, filename: str, weighted: bool = False):
        self.filename = filename
        self.weighted = weighted

    def write_coo(self, coo: COO) -> None:
        coo = coo.to_host()
        row, col = np.asarray(coo.row), np.asarray(coo.col)
        vals = None if coo.vals is None else np.asarray(coo.vals)
        with open(self.filename, "w") as f:
            if self.weighted and vals is not None:
                for r, c, v in zip(row, col, vals):
                    f.write(f"{int(r)} {int(c)} {v}\n")
            else:
                for r, c in zip(row, col):
                    f.write(f"{int(r)} {int(c)}\n")

    def write_csr(self, csr: CSR) -> None:
        from ..convert import csr_to_coo

        self.write_coo(csr_to_coo(csr.to_host()))
