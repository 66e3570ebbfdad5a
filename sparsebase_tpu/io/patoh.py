"""PaToH hypergraph file reader/writer.

JAX-native analogue of the reference PaToH I/O
(reference: src/sparsebase/io/patoh_reader.cc:10-247,
patoh_writer.cc). File layout:

* header: ``base cell_num net_num pin_num [weighted_scheme [constraint_num]]``
  where weighted_scheme 1 = cells weighted, 2 = nets weighted, 3 = both
  (patoh_reader.h:28-36)
* one line per net: ``[net_weight if scheme in {2,3}] pin ids...``
* if scheme in {1,3}: a final line of cell weights

The reader builds the net→cell pin CSR (connectivity) and its transpose
cell→net CSR (xnet) — the reference computes the transpose with an
O(cells × pins) scan (patoh_reader.cc:92-133); here it's a vectorized
stable sort.
"""

from __future__ import annotations

import numpy as np

from ..formats.array import DenseArray
from ..formats.csr import CSR
from ..objects import HyperGraph
from ..utils.exceptions import ReaderError, WriterError


class PatohReader:
    """Reads a PaToH hypergraph file into :class:`HyperGraph`."""

    def __init__(self, filename: str):
        self.filename = filename

    def read_hypergraph(self) -> HyperGraph:
        try:
            with open(self.filename) as f:
                lines = [l.strip() for l in f if not l.startswith("%")]
        except OSError:
            raise ReaderError("Can not read HyperGraph")
        lines = [l for l in lines if l]
        if not lines:
            raise ReaderError("Empty PaToH file")
        header = lines[0].split()
        if len(header) < 4:
            raise ReaderError(f"Bad PaToH header: {lines[0]!r}")
        base = int(header[0])
        n_cells, n_nets, n_pins = int(header[1]), int(header[2]), int(header[3])
        scheme = int(header[4]) if len(header) > 4 else 0
        constraint_num = int(header[5]) if len(header) > 5 else 1

        cells_weighted = scheme in (1, 3)
        nets_weighted = scheme in (2, 3)

        net_lines = lines[1 : 1 + n_nets]
        if len(net_lines) < n_nets:
            raise ReaderError(f"Expected {n_nets} net lines, found {len(net_lines)}")
        pins, xpins = [], [0]
        net_weights = np.ones(n_nets, dtype=np.int32)
        for k, line in enumerate(net_lines):
            toks = [int(t) for t in line.split()]
            if nets_weighted:
                net_weights[k] = toks[0]
                toks = toks[1:]
            pins.extend(toks)
            xpins.append(xpins[-1] + len(toks))
        if len(pins) != n_pins:
            raise ReaderError(f"Expected {n_pins} pins, found {len(pins)}")

        cell_weights = np.ones(n_cells, dtype=np.int32)
        if cells_weighted:
            tail = []
            for line in lines[1 + n_nets :]:
                tail.extend(int(t) for t in line.split())
            if len(tail) < n_cells * constraint_num:
                raise ReaderError("Missing cell weight line(s)")
            cell_weights = np.array(tail[: n_cells * constraint_num], dtype=np.int32)
            if constraint_num == 1:
                cell_weights = cell_weights[:n_cells]

        pin_arr = np.array(pins, dtype=np.int32)
        xpin_arr = np.array(xpins, dtype=np.int32)
        # connectivity: net × cell CSR, indices keep the file's base offset
        # (patoh_reader.cc:136-142 keeps base-1 ids as-is)
        con = CSR(xpin_arr, pin_arr, None, (n_nets, n_cells + base))
        # transpose: cell × net CSR via stable sort on (cell, net)
        net_of_pin = (
            np.searchsorted(xpin_arr, np.arange(n_pins), side="right") - 1
        ).astype(np.int32)
        cell0 = pin_arr - base  # 0-based cell ids
        order = np.argsort(cell0, kind="stable")
        xnet_counts = np.bincount(cell0, minlength=n_cells)
        xnet_arr = np.concatenate([[0], np.cumsum(xnet_counts)]).astype(np.int32)
        net_arr = (net_of_pin[order] + base).astype(np.int32)
        xnet = CSR(xnet_arr, net_arr, None, (n_cells, n_nets + base))
        return HyperGraph(
            con,
            xnet,
            net_weights=DenseArray.new(net_weights) if nets_weighted else None,
            cell_weights=DenseArray.new(cell_weights) if cells_weighted else None,
            base_type=base,
            constraint_num=constraint_num,
        )


class PatohWriter:
    """Writes a :class:`HyperGraph` as a PaToH file
    (patoh_writer.cc parity: base conversion via is_zero_indexed,
    optional net/cell weight emission)."""

    def __init__(
        self,
        filename: str,
        is_zero_indexed: bool = True,
        is_edge_weighted: bool = False,
        is_vertex_weighted: bool = False,
        constraint_num: int = 1,
    ):
        self.filename = filename
        self.is_zero_indexed = is_zero_indexed
        self.is_edge_weighted = is_edge_weighted
        self.is_vertex_weighted = is_vertex_weighted
        self.constraint_num = constraint_num

    def write_hypergraph(self, hg: HyperGraph) -> None:
        con = hg.connectivity
        if con is None:
            raise WriterError("HyperGraph has no connectivity")
        con = con.as_format(CSR).to_host()
        xpin = np.asarray(con.indptr)
        pin = np.asarray(con.indices).astype(np.int64)
        n_nets = con.shape[0]
        n_pins = pin.shape[0]
        n_cells = hg.num_cells

        out_base = 0 if self.is_zero_indexed else 1
        pin_out = pin - hg.base_type + out_base

        scheme = (1 if self.is_vertex_weighted else 0) + (2 if self.is_edge_weighted else 0)
        header = f"{out_base} {n_cells} {n_nets} {n_pins}"
        if scheme:
            header += f" {scheme}"
            if self.constraint_num != 1:
                header += f" {self.constraint_num}"
        net_w = (
            np.asarray(hg.net_weights.vals)
            if (self.is_edge_weighted and hg.net_weights is not None)
            else None
        )
        with open(self.filename, "w") as f:
            f.write(header + "\n")
            for k in range(n_nets):
                seg = pin_out[xpin[k] : xpin[k + 1]]
                parts = []
                if net_w is not None:
                    parts.append(str(int(net_w[k])))
                parts.extend(str(int(p)) for p in seg)
                f.write(" ".join(parts) + "\n")
            if self.is_vertex_weighted:
                cw = (
                    np.asarray(hg.cell_weights.vals)
                    if hg.cell_weights is not None
                    else np.ones(n_cells, dtype=np.int32)
                )
                f.write(" ".join(str(int(w)) for w in cw) + "\n")
