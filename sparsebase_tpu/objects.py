"""Semantic graph wrappers over formats.

JAX-native analogue of the reference object layer
(reference: src/sparsebase/object/object.h:28-87, object.cc:101-183):
``Object``/``AbstractObject`` become a single Python base holding a
connectivity format; ``Graph`` carries n/m and optional multi-constraint
vertex weights (``ncon``); ``HyperGraph`` adds the transpose net structure
(xNetCSR), net/cell weights, base index and constraint count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .formats.array import DenseArray
from .formats.base import Format
from .formats.coo import COO
from .formats.csr import CSR


class Object:
    """Abstract object with a connectivity format (object/object.h:28-48)."""

    def __init__(self, connectivity: Optional[Format] = None):
        self._connectivity = connectivity

    @property
    def connectivity(self) -> Optional[Format]:
        return self._connectivity

    def set_connectivity(self, fmt: Format) -> None:
        self._connectivity = fmt
        self.initialize_info_from_connection()

    def initialize_info_from_connection(self) -> None:
        pass

    def verify_structure(self) -> None:
        raise NotImplementedError


class Graph(Object):
    """A (possibly weighted) graph over an order-2 connectivity format.

    Parity: ``object::Graph`` (object/object.h:52-75). ``vertex_weights``
    is a list of n DenseArrays of length ``ncon`` (one weight vector per
    vertex), matching the reference's ``format::Array<Weight>**``.
    """

    def __init__(
        self,
        connectivity: Optional[Format] = None,
        ncon: int = 0,
        vertex_weights: Optional[List[DenseArray]] = None,
    ):
        super().__init__(connectivity)
        self.n = 0
        self.m = 0
        self.ncon = int(ncon)
        self.vertex_weights = vertex_weights
        if connectivity is not None:
            self.initialize_info_from_connection()

    def initialize_info_from_connection(self) -> None:
        fmt = self._connectivity
        if fmt is None:
            return
        self.n = fmt.shape[0]
        self.m = fmt.nnz

    def verify_structure(self) -> None:
        fmt = self._connectivity
        if fmt is None:
            raise ValueError("Graph has no connectivity")
        if fmt.order != 2:
            raise ValueError("Graph connectivity must be order-2")
        if self.vertex_weights is not None and len(self.vertex_weights) != self.n:
            raise ValueError(
                f"Expected {self.n} vertex weight arrays, got {len(self.vertex_weights)}"
            )

    # -- reader-driven constructors (object.cc:101-142 parity) ---------------
    @staticmethod
    def read_connectivity_from_mtx_to_coo(filename: str) -> "Graph":
        from .io.mtx import MTXReader

        return Graph(MTXReader(filename).read_coo())

    @staticmethod
    def read_connectivity_from_edgelist_to_csr(filename: str) -> "Graph":
        from .io.edge_list import EdgeListReader

        return Graph(EdgeListReader(filename).read_csr())

    def __repr__(self) -> str:
        return f"Graph(n={self.n}, m={self.m}, ncon={self.ncon})"


class HyperGraph(Graph):
    """Hypergraph: connectivity = net→cell pin CSR; xnet = cell→net CSR.

    Parity: ``object::HyperGraph`` (object/object.h:76-87). ``base_type``
    is the file's base index (0 or 1); ``constraint_num`` the number of
    balance constraints.
    """

    def __init__(
        self,
        connectivity: Format,
        xnet_csr: CSR,
        net_weights: Optional[DenseArray] = None,
        cell_weights: Optional[DenseArray] = None,
        base_type: int = 0,
        constraint_num: int = 1,
    ):
        super().__init__(connectivity)
        self.xnet_csr = xnet_csr
        self.net_weights = net_weights
        self.cell_weights = cell_weights
        self.base_type = int(base_type)
        self.constraint_num = int(constraint_num)

    @property
    def num_nets(self) -> int:
        return self._connectivity.shape[0]

    @property
    def num_cells(self) -> int:
        return self.xnet_csr.shape[0]

    def verify_structure(self) -> None:
        super().verify_structure()
        if self.xnet_csr.nnz != self._connectivity.nnz:
            raise ValueError("pin counts of net and xnet structures disagree")

    def __repr__(self) -> str:
        return (
            f"HyperGraph(nets={self.num_nets}, cells={self.num_cells}, "
            f"pins={self._connectivity.nnz}, base={self.base_type})"
        )
