"""Static façades: the "easy" API.

JAX-native analogue of the reference bases layer
(reference: src/sparsebase/bases/iobase.h:46-390,
reorder_base.h:29-708, graph_feature_base.h:20-135). Each façade is a
class of static one-liners delegating to readers/ops.

``ReorderBase`` and ``GraphFeatureBase`` methods appear here as the ops
layers land (ops/reorder, ops/feature).
"""

from __future__ import annotations

from typing import Optional, Type

from .context import Context
from .formats.array import DenseArray
from .formats.coo import COO
from .formats.csr import CSR
from .formats.base import Format


class ReorderBase:
    """Parity: ``bases::ReorderBase`` (bases/reorder_base.h:29-708) —
    reorder / permute / inverse-permutation / heatmap one-liners."""

    @staticmethod
    def _resolve(reorderer_cls):
        """Accept a Reorderer class or its short name ("rcm", "degree",
        "gray", "slashburn", "boba", "amd", "metis"/"nested_dissection",
        "rabbit")."""
        if not isinstance(reorderer_cls, str):
            return reorderer_cls
        from .ops import reorder as _r

        aliases = {
            "degree": _r.DegreeReorder,
            "rcm": _r.RCMReorder,
            "gray": _r.GrayReorder,
            "slashburn": _r.SlashburnReorder,
            "boba": _r.BOBAReorder,
            "amd": _r.AMDReorder,
            "metis": _r.MetisReorder,
            "nested_dissection": _r.MetisReorder,
            "rabbit": _r.RabbitReorder,
        }
        key = reorderer_cls.lower()
        if key not in aliases:
            raise KeyError(
                f"unknown reorderer {reorderer_cls!r}; one of {sorted(aliases)}"
            )
        return aliases[key]

    @staticmethod
    def reorder(reorderer_cls, fmt: Format, params=None, context=None, convert_input=True):
        """Run a reorderer class or short name (Reorder, reorder_base.h:50-85)."""
        reorderer_cls = ReorderBase._resolve(reorderer_cls)
        op = reorderer_cls(**params) if isinstance(params, dict) else (
            reorderer_cls(params) if params is not None else reorderer_cls()
        )
        return op.get_reorder(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def reorder_cached(reorderer_cls, fmt: Format, params=None, context=None):
        reorderer_cls = ReorderBase._resolve(reorderer_cls)
        op = reorderer_cls(**params) if isinstance(params, dict) else (
            reorderer_cls(params) if params is not None else reorderer_cls()
        )
        return op.get_reorder_cached(fmt, context=context)

    @staticmethod
    def permute2d(order, fmt, context=None, convert_input=True):
        """Apply one order to rows and columns (Permute2D,
        reorder_base.h:145-192)."""
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(order, order).get_permutation(
            fmt, context=context, convert_input=convert_input
        )

    @staticmethod
    def permute2d_cached(order, fmt, context=None):
        """(Permute2DCached, reorder_base.h:196-…): returns
        ``(intermediates, permuted)`` — the conversions actually run."""
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(order, order).get_permutation_cached(
            fmt, context=context
        )

    @staticmethod
    def permute1d_cached(order, arr, context=None):
        """(Permute1DCached, reorder_base.h:624-…)."""
        from .ops.permute import PermuteOrderOne

        op = PermuteOrderOne(order)
        return op.execute_cached(op.params, arr, context=context)

    @staticmethod
    def permute2d_rowwise(order, fmt, context=None, convert_input=True):
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(order, None).get_permutation(
            fmt, context=context, convert_input=convert_input
        )

    @staticmethod
    def permute2d_colwise(order, fmt, context=None, convert_input=True):
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(None, order).get_permutation(
            fmt, context=context, convert_input=convert_input
        )

    @staticmethod
    def permute2d_row_columnwise(row_order, col_order, fmt, context=None, convert_input=True):
        from .ops.permute import PermuteOrderTwo

        return PermuteOrderTwo(row_order, col_order).get_permutation(
            fmt, context=context, convert_input=convert_input
        )

    @staticmethod
    def permute1d(order, arr, context=None, convert_input=True):
        from .ops.permute import PermuteOrderOne

        return PermuteOrderOne(order).get_permutation(
            arr, context=context, convert_input=convert_input
        )

    @staticmethod
    def inverse_permutation(perm):
        """(InversePermutation, reorder_base.h:663-694)."""
        from .ops.permute import inverse_permutation as inv

        return inv(perm)

    @staticmethod
    def heatmap(fmt, order_r, order_c, num_parts: int = 8, context=None):
        """(Heatmap, reorder_base.h:696-708)."""
        from .ops.reorder.heatmap import ReorderHeatmap

        if not isinstance(order_r, DenseArray):
            order_r = DenseArray.new(order_r)
        if not isinstance(order_c, DenseArray):
            order_c = DenseArray.new(order_c)
        return ReorderHeatmap(num_parts).get_heatmap(fmt, order_r, order_c, context=context)

    @staticmethod
    def heatmap_with_stats(fmt, order_r, order_c, num_parts: int = 8, context=None):
        """(heatmap, stats) in one fused pass; stats = mean/max bandwidth,
        full-block count, block bandwidth — the internal stats the
        reference computes alongside the grid (reorder_heatmap.cc:58-106)."""
        from .ops.reorder.heatmap import ReorderHeatmap

        if not isinstance(order_r, DenseArray):
            order_r = DenseArray.new(order_r)
        if not isinstance(order_c, DenseArray):
            order_c = DenseArray.new(order_c)
        return ReorderHeatmap(num_parts).get_heatmap_with_stats(
            fmt, order_r, order_c, context=context
        )


class GraphFeatureBase:
    """Parity: ``bases::GraphFeatureBase`` (bases/graph_feature_base.h:20-135)
    — extended with a general ``extract`` running the fused extractor."""

    @staticmethod
    def get_degrees(fmt: Format, context=None, convert_input=True):
        from .ops.feature import Degrees

        return Degrees().get_degrees(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def get_degree_distribution(fmt: Format, context=None, convert_input=True):
        from .ops.feature import DegreeDistribution

        return DegreeDistribution().get_distribution(
            fmt, context=context, convert_input=convert_input
        )

    @staticmethod
    def get_degrees_cached(fmt: Format, context=None):
        from .ops.feature import Degrees

        op = Degrees()
        return op.execute_cached(op.params, fmt, context=context)

    @staticmethod
    def get_fill_in(fmt: Format, context=None, convert_input=True):
        """Symbolic-factorization nnz(L) of the current row order — the
        fill metric AMD/nested-dissection orderings are judged on (no
        reference facade; the reference outsources fill quality to
        SuiteSparse, amd_reorder.cc:29-57)."""
        from .ops.feature import FillIn

        return FillIn().get_fill(fmt, context=context, convert_input=convert_input)

    @staticmethod
    def extract(features, fmt: Format, context=None, convert_input=True):
        """Fused multi-feature extraction (feature::Extractor::Extract)."""
        from .ops.feature import FeatureExtractor

        return FeatureExtractor().extract(
            fmt, features=features, context=context, convert_input=convert_input
        )


class IOBase:
    """Parity: ``bases::IOBase`` (bases/iobase.h:46-390) — 19 static
    read/write helpers."""

    # -- MTX -----------------------------------------------------------------
    @staticmethod
    def read_mtx_to_csr(filename: str, convert_to_zero_index: bool = True, **kw) -> CSR:
        from .io.mtx import MTXReader

        return MTXReader(filename, convert_to_zero_index, **kw).read_csr()

    @staticmethod
    def read_mtx_to_coo(filename: str, convert_to_zero_index: bool = True, **kw) -> COO:
        from .io.mtx import MTXReader

        return MTXReader(filename, convert_to_zero_index, **kw).read_coo()

    @staticmethod
    def read_mtx_to_array(filename: str, **kw) -> DenseArray:
        from .io.mtx import MTXReader

        return MTXReader(filename, **kw).read_array()

    # PIGO-parallel variants: native mmap+OpenMP parse path when the
    # fastio extension builds; falls back to the numpy path.
    @staticmethod
    def read_pigo_mtx_to_csr(filename: str, convert_to_zero_index: bool = True, **kw) -> CSR:
        from .io.pigo import PigoMTXReader

        return PigoMTXReader(filename, convert_to_zero_index, **kw).read_csr()

    @staticmethod
    def read_pigo_mtx_to_coo(filename: str, convert_to_zero_index: bool = True, **kw) -> COO:
        from .io.pigo import PigoMTXReader

        return PigoMTXReader(filename, convert_to_zero_index, **kw).read_coo()

    # -- edge list -----------------------------------------------------------
    @staticmethod
    def read_edge_list_to_csr(filename: str, **kw) -> CSR:
        from .io.edge_list import EdgeListReader

        return EdgeListReader(filename, **kw).read_csr()

    @staticmethod
    def read_edge_list_to_coo(filename: str, **kw) -> COO:
        from .io.edge_list import EdgeListReader

        return EdgeListReader(filename, **kw).read_coo()

    @staticmethod
    def read_pigo_edge_list_to_csr(filename: str, **kw) -> CSR:
        from .io.pigo import PigoEdgeListReader

        return PigoEdgeListReader(filename, **kw).read_csr()

    @staticmethod
    def read_pigo_edge_list_to_coo(filename: str, **kw) -> COO:
        from .io.pigo import PigoEdgeListReader

        return PigoEdgeListReader(filename, **kw).read_coo()

    # -- SBFF binary ---------------------------------------------------------
    @staticmethod
    def read_binary_to_csr(filename: str) -> CSR:
        from .io.binary import BinaryReaderOrderTwo

        return BinaryReaderOrderTwo(filename).read_csr()

    @staticmethod
    def read_binary_to_coo(filename: str) -> COO:
        from .io.binary import BinaryReaderOrderTwo

        return BinaryReaderOrderTwo(filename).read_coo()

    @staticmethod
    def read_binary_to_array(filename: str) -> DenseArray:
        from .io.binary import BinaryReaderOrderOne

        return BinaryReaderOrderOne(filename).read_array()

    @staticmethod
    def write_csr_to_binary(csr: CSR, filename: str) -> None:
        from .io.binary import BinaryWriterOrderTwo

        BinaryWriterOrderTwo(filename).write_csr(csr)

    @staticmethod
    def write_coo_to_binary(coo: COO, filename: str) -> None:
        from .io.binary import BinaryWriterOrderTwo

        BinaryWriterOrderTwo(filename).write_coo(coo)

    @staticmethod
    def write_array_to_binary(arr: DenseArray, filename: str) -> None:
        from .io.binary import BinaryWriterOrderOne

        BinaryWriterOrderOne(filename).write_array(arr)

    # -- MTX writing ---------------------------------------------------------
    @staticmethod
    def write_coo_to_mtx(coo: COO, filename: str, **kw) -> None:
        from .io.mtx import MTXWriter

        kw.setdefault("field", "pattern" if coo.vals is None else "real")
        MTXWriter(filename, **kw).write_coo(coo)

    @staticmethod
    def write_csr_to_mtx(csr: CSR, filename: str, **kw) -> None:
        from .io.mtx import MTXWriter

        kw.setdefault("field", "pattern" if csr.vals is None else "real")
        MTXWriter(filename, **kw).write_csr(csr)

    @staticmethod
    def write_array_to_mtx(arr: DenseArray, filename: str, **kw) -> None:
        from .io.mtx import MTXWriter

        MTXWriter(filename, format="array", **kw).write_array(arr)
