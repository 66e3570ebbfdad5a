"""I/O tests (parity: tests/suites/sparsebase/io/* — embedded literal file
contents written to temp files, then read back; writers tested by
write→reread round trip)."""

import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO, CSC, CSR, DenseArray
from sparsebase_tpu.bases import IOBase
from sparsebase_tpu.io import (
    BinaryReaderOrderOne,
    BinaryReaderOrderTwo,
    BinaryWriterOrderOne,
    BinaryWriterOrderTwo,
    EdgeListReader,
    EdgeListWriter,
    MetisGraphReader,
    MetisGraphWriter,
    MTXReader,
    MTXWriter,
    PatohReader,
    PatohWriter,
)
from sparsebase_tpu.objects import Graph, HyperGraph
from sparsebase_tpu.utils.exceptions import ReaderError

MTX_GENERAL = """%%MatrixMarket matrix coordinate integer general
%comment
3 3 4
1 2 1
1 3 2
2 1 3
3 1 4
"""

MTX_PATTERN = """%%MatrixMarket matrix coordinate pattern general
3 3 4
1 2
1 3
2 1
3 1
"""

MTX_SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
3 3 3
1 1 1.0
2 1 2.0
3 2 3.0
"""

MTX_SKEW = """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 2.0
3 2 3.0
"""

MTX_ARRAY = """%%MatrixMarket matrix array real general
3 2
1.0
0.0
2.0
0.0
3.0
4.0
"""


class TestMTXReader:
    def test_general_integer(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_GENERAL)
        coo = MTXReader(str(p)).read_coo()
        assert coo.shape == (3, 3)
        np.testing.assert_array_equal(coo.to_dense(), fx.DENSE)

    def test_read_csr(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_GENERAL)
        csr = MTXReader(str(p)).read_csr()
        fx.compare_csr(fx.make_csr(), csr.astype(id_dtype=np.int32, nnz_dtype=np.int32))

    def test_pattern(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_PATTERN)
        coo = MTXReader(str(p)).read_coo()
        assert coo.vals is None
        np.testing.assert_array_equal(coo.to_dense(), (fx.DENSE != 0).astype(np.int8))

    def test_one_indexed(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_GENERAL)
        coo = MTXReader(str(p), convert_to_zero_index=False).read_coo()
        assert int(np.asarray(coo.row).min()) == 1

    def test_symmetric_expansion(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_SYMMETRIC)
        coo = MTXReader(str(p)).read_coo()
        # diagonal (1,1) not mirrored; (2,1),(3,2) mirrored -> nnz=5
        assert coo.nnz == 5
        d = np.asarray(coo.to_dense())
        np.testing.assert_array_equal(d, d.T)

    def test_skew_expansion(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_SKEW)
        coo = MTXReader(str(p)).read_coo()
        assert coo.nnz == 4
        d = np.asarray(coo.to_dense())
        np.testing.assert_array_equal(d, -d.T)

    def test_upper_triangle_fold(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_SYMMETRIC)
        coo = MTXReader(str(p), upper_triangle=True).read_coo()
        assert coo.nnz == 3
        r, c = np.asarray(coo.row), np.asarray(coo.col)
        assert np.all(r <= c)

    def test_array_format(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_ARRAY)
        coo = MTXReader(str(p)).read_coo()
        assert coo.shape == (3, 2)
        expect = np.array([[1, 0], [0, 3], [2, 4]], dtype=np.float32)
        np.testing.assert_array_equal(coo.to_dense(), expect)
        arr = MTXReader(str(p)).read_array()
        assert arr.shape == (6,)

    def test_bad_header(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text("%%MatrixMarket tensor coordinate real general\n1 1 0\n")
        with pytest.raises(ReaderError):
            MTXReader(str(p))
        p.write_text("%%MatrixMarket vector coordinate real general\n1 1 0\n")
        with pytest.raises(ReaderError):
            MTXReader(str(p))
        p.write_text("%%MatrixMarket matrix coordinate real hermitian\n1 1 0\n")
        with pytest.raises(ReaderError):
            MTXReader(str(p))

    def test_roundtrip_coo(self, tmp_path):
        p = tmp_path / "rt.mtx"
        coo = fx.make_coo()
        MTXWriter(str(p), field="integer").write_coo(coo)
        back = MTXReader(str(p)).read_coo()
        np.testing.assert_array_equal(back.to_dense(), fx.DENSE)

    def test_complex_coordinate(self, tmp_path):
        # complex field: reference keeps the real column
        # (mtx_reader.cc:78-80,170); a complex value_dtype keeps both.
        p = tmp_path / "c.mtx"
        p.write_text(
            "%%MatrixMarket matrix coordinate complex general\n"
            "2 2 2\n1 1 1.5 -2.0\n2 2 0.0 3.0\n"
        )
        real = MTXReader(str(p)).read_coo()
        np.testing.assert_allclose(np.asarray(real.vals), [1.5, 0.0])
        full = MTXReader(str(p), value_dtype=np.complex128).read_coo()
        assert np.asarray(full.vals).dtype == np.complex128
        np.testing.assert_allclose(np.asarray(full.vals), [1.5 - 2j, 3j])
        # 3-column body under a complex header is malformed
        p.write_text(
            "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 1.5\n"
        )
        with pytest.raises(ReaderError):
            MTXReader(str(p)).read_coo()

    def test_complex_array(self, tmp_path):
        p = tmp_path / "c.mtx"
        p.write_text(
            "%%MatrixMarket matrix array complex general\n"
            "2 1 \n1.0 2.0\n0.0 -1.0\n"
        )
        arr = MTXReader(str(p), value_dtype=np.complex128).read_array()
        np.testing.assert_allclose(np.asarray(arr.vals), [1 + 2j, -1j])
        coo = MTXReader(str(p), value_dtype=np.complex128).read_coo()
        assert coo.nnz == 2  # 0-1j is nonzero
        real_default = MTXReader(str(p)).read_array()
        np.testing.assert_allclose(np.asarray(real_default.vals), [1.0, 0.0])

    def test_complex_roundtrip(self, tmp_path):
        p = tmp_path / "c.mtx"
        row = np.array([0, 1], np.int32)
        col = np.array([1, 0], np.int32)
        vals = np.array([1 + 2j, -3.5j], np.complex128)
        from sparsebase_tpu.formats.coo import COO

        coo = COO.new(row, col, vals, shape=(2, 2))
        MTXWriter(str(p), field="complex").write_coo(coo)
        back = MTXReader(str(p), value_dtype=np.complex128).read_coo()
        np.testing.assert_allclose(np.asarray(back.vals), vals)

    def test_roundtrip_pattern(self, tmp_path):
        p = tmp_path / "rt.mtx"
        csr = fx.make_pattern_csr()
        MTXWriter(str(p), field="pattern").write_csr(csr)
        back = MTXReader(str(p)).read_csr()
        fx.compare_csr(fx.make_pattern_csr(), back.astype(id_dtype=np.int32, nnz_dtype=np.int32))

    def test_roundtrip_symmetric_write(self, tmp_path):
        p = tmp_path / "rt.mtx"
        sym = np.array([[0, 2, 0], [2, 0, 3], [0, 3, 1]], dtype=np.float32)
        r, c = np.nonzero(sym)
        coo = COO.new(r.astype(np.int32), c.astype(np.int32), sym[r, c], shape=(3, 3))
        MTXWriter(str(p), symmetry="symmetric").write_coo(coo)
        back = MTXReader(str(p)).read_coo()
        np.testing.assert_array_equal(back.to_dense(), sym)

    def test_roundtrip_array(self, tmp_path):
        p = tmp_path / "rt.mtx"
        arr = DenseArray.new(fx.ORIGINAL_ARRAY.copy())
        MTXWriter(str(p), format="array").write_array(arr)
        back = MTXReader(str(p)).read_array()
        np.testing.assert_allclose(np.asarray(back.vals), fx.ORIGINAL_ARRAY)

    def test_real_matrix_ash958(self):
        # A ∪ Aᵀ of the reference's 958x292 ash958: 1916 entries each way,
        # duplicates (the doubled diagonal) kept as stored
        csr = IOBase.read_mtx_to_csr(fx.ASH958_SYM)
        assert csr.shape == (958, 958)
        assert csr.nnz == 3832


class TestEdgeList:
    CONTENT = "0 1\n1 2\n2 0\n"
    WEIGHTED = "0 1 0.5\n1 2 1.5\n"

    def test_read_undirected_default(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text(self.CONTENT)
        coo = EdgeListReader(str(p)).read_coo()
        assert coo.nnz == 6  # doubled
        d = np.asarray(coo.to_dense())
        np.testing.assert_array_equal(d, d.T)

    def test_directed(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text(self.CONTENT)
        coo = EdgeListReader(str(p), read_undirected=False).read_coo()
        assert coo.nnz == 3

    def test_weighted(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text(self.WEIGHTED)
        coo = EdgeListReader(str(p), weighted=True, read_undirected=False).read_coo()
        np.testing.assert_allclose(np.asarray(coo.vals), [0.5, 1.5])

    def test_remove_self_edges_and_duplicates(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text("0 0\n0 1\n0 1\n1 0\n")
        coo = EdgeListReader(
            str(p), remove_duplicates=True, remove_self_edges=True, read_undirected=False
        ).read_coo()
        assert coo.nnz == 2  # (0,1) dedup'd, (1,0) kept, (0,0) dropped

    def test_roundtrip(self, tmp_path):
        p = tmp_path / "e.txt"
        coo = fx.make_coo()
        EdgeListWriter(str(p), weighted=True).write_coo(coo)
        back = EdgeListReader(str(p), weighted=True, read_undirected=False).read_coo()
        np.testing.assert_array_equal(back.to_dense(), fx.DENSE)


class TestBinary:
    def test_csr_roundtrip(self, tmp_path):
        p = str(tmp_path / "m.sbff")
        BinaryWriterOrderTwo(p).write_csr(fx.make_csr())
        back = BinaryReaderOrderTwo(p).read_csr()
        assert back.shape == (3, 3)
        fx.compare_csr(fx.make_csr(), back)

    def test_coo_roundtrip(self, tmp_path):
        p = str(tmp_path / "m.sbff")
        BinaryWriterOrderTwo(p).write_coo(fx.make_coo())
        back = BinaryReaderOrderTwo(p).read_coo()
        np.testing.assert_array_equal(back.to_dense(), fx.DENSE)

    def test_pattern_roundtrip(self, tmp_path):
        p = str(tmp_path / "m.sbff")
        BinaryWriterOrderTwo(p).write_csr(fx.make_pattern_csr())
        back = BinaryReaderOrderTwo(p).read_csr()
        assert back.vals is None

    def test_array_roundtrip(self, tmp_path):
        p = str(tmp_path / "a.sbff")
        BinaryWriterOrderOne(p).write_array(DenseArray.new(fx.ORIGINAL_ARRAY.copy()))
        back = BinaryReaderOrderOne(p).read_array()
        np.testing.assert_array_equal(np.asarray(back.vals), fx.ORIGINAL_ARRAY)

    def test_wrong_object_raises(self, tmp_path):
        p = str(tmp_path / "m.sbff")
        BinaryWriterOrderTwo(p).write_csr(fx.make_csr())
        with pytest.raises(ReaderError):
            BinaryReaderOrderTwo(p).read_coo()


METIS_PLAIN = """7 11
5 3 2
1 3 4
5 4 2 1
2 3 6 7
1 3 6
5 4 7
6 4
"""

METIS_WEIGHTED = """7 11 001
5 1 3 2 2 1
1 1 3 2 4 1
5 3 4 2 2 2 1 2
2 1 3 2 6 2 7 5
1 1 3 3 6 2
5 2 4 2 7 6
6 6 4 5
"""

METIS_VWGT = """7 11 010 1
4 5 3 2
2 1 3 4
5 5 4 2 1
3 2 3 6 7
1 1 3 6
6 5 4 7
2 6 4
"""


class TestMetisGraph:
    def test_plain(self, tmp_path):
        p = tmp_path / "g.graph"
        p.write_text(METIS_PLAIN)
        g = MetisGraphReader(str(p)).read_graph()
        assert g.n == 7
        assert g.m == 22
        d = np.asarray(g.connectivity.to_dense())
        np.testing.assert_array_equal(d, d.T)

    def test_edge_weighted(self, tmp_path):
        p = tmp_path / "g.graph"
        p.write_text(METIS_WEIGHTED)
        g = MetisGraphReader(str(p)).read_graph()
        assert g.m == 22
        assert g.connectivity.vals is not None

    def test_vertex_weighted(self, tmp_path):
        p = tmp_path / "g.graph"
        p.write_text(METIS_VWGT)
        g = MetisGraphReader(str(p)).read_graph()
        assert g.ncon == 1
        assert len(g.vertex_weights) == 7
        assert int(np.asarray(g.vertex_weights[0].vals)[0]) == 4

    def test_one_indexed(self, tmp_path):
        p = tmp_path / "g.graph"
        p.write_text(METIS_PLAIN)
        g = MetisGraphReader(str(p), convert_to_zero_index=False).read_graph()
        assert g.connectivity.shape == (8, 8)

    def test_roundtrip(self, tmp_path):
        p = tmp_path / "g.graph"
        p.write_text(METIS_PLAIN)
        g = MetisGraphReader(str(p)).read_graph()
        p2 = tmp_path / "g2.graph"
        MetisGraphWriter(str(p2)).write_graph(g)
        g2 = MetisGraphReader(str(p2)).read_graph()
        np.testing.assert_array_equal(
            np.asarray(g.connectivity.to_dense()), np.asarray(g2.connectivity.to_dense())
        )


PATOH_PLAIN = """0 6 4 12
0 2
0 1 3
3 4 5
2 4 5 3
"""

PATOH_WEIGHTED = """1 6 4 12 3
2 1 3
1 1 2 4
3 4 5 6
1 3 5 6 4
1 2 3 4 5 6
"""


class TestPatoh:
    def test_plain(self, tmp_path):
        p = tmp_path / "h.patoh"
        p.write_text(PATOH_PLAIN)
        hg = PatohReader(str(p)).read_hypergraph()
        assert hg.num_nets == 4
        assert hg.num_cells == 6
        assert hg.connectivity.nnz == 12
        assert hg.xnet_csr.nnz == 12
        # cell 3 appears in nets 1, 2, 3
        xn = hg.xnet_csr
        nets_of_3 = np.asarray(xn.indices)[int(xn.indptr[3]) : int(xn.indptr[4])]
        assert sorted(nets_of_3.tolist()) == [1, 2, 3]

    def test_weighted_base1(self, tmp_path):
        p = tmp_path / "h.patoh"
        p.write_text(PATOH_WEIGHTED)
        hg = PatohReader(str(p)).read_hypergraph()
        assert hg.base_type == 1
        np.testing.assert_array_equal(np.asarray(hg.net_weights.vals), [2, 1, 3, 1])
        np.testing.assert_array_equal(np.asarray(hg.cell_weights.vals), [1, 2, 3, 4, 5, 6])

    def test_roundtrip(self, tmp_path):
        p = tmp_path / "h.patoh"
        p.write_text(PATOH_PLAIN)
        hg = PatohReader(str(p)).read_hypergraph()
        p2 = tmp_path / "h2.patoh"
        PatohWriter(str(p2)).write_hypergraph(hg)
        hg2 = PatohReader(str(p2)).read_hypergraph()
        np.testing.assert_array_equal(
            np.asarray(hg.connectivity.indptr), np.asarray(hg2.connectivity.indptr)
        )
        np.testing.assert_array_equal(
            np.asarray(hg.connectivity.indices), np.asarray(hg2.connectivity.indices)
        )

    def test_weighted_roundtrip(self, tmp_path):
        p = tmp_path / "h.patoh"
        p.write_text(PATOH_WEIGHTED)
        hg = PatohReader(str(p)).read_hypergraph()
        p2 = tmp_path / "h2.patoh"
        PatohWriter(
            str(p2), is_zero_indexed=False, is_edge_weighted=True, is_vertex_weighted=True
        ).write_hypergraph(hg)
        hg2 = PatohReader(str(p2)).read_hypergraph()
        np.testing.assert_array_equal(
            np.asarray(hg.net_weights.vals), np.asarray(hg2.net_weights.vals)
        )
        np.testing.assert_array_equal(
            np.asarray(hg.cell_weights.vals), np.asarray(hg2.cell_weights.vals)
        )


class TestIOBase:
    def test_facades(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_GENERAL)
        csr = IOBase.read_mtx_to_csr(str(p))
        coo = IOBase.read_mtx_to_coo(str(p))
        assert csr.nnz == coo.nnz == 4
        b = str(tmp_path / "m.sbff")
        IOBase.write_csr_to_binary(csr, b)
        back = IOBase.read_binary_to_csr(b)
        np.testing.assert_array_equal(back.to_dense(), fx.DENSE)
        m2 = str(tmp_path / "out.mtx")
        IOBase.write_coo_to_mtx(coo, m2, field="integer")
        np.testing.assert_array_equal(IOBase.read_mtx_to_coo(m2).to_dense(), fx.DENSE)


class TestGraphObject:
    def test_from_mtx(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_GENERAL)
        g = Graph.read_connectivity_from_mtx_to_coo(str(p))
        assert g.n == 3 and g.m == 4
        g.verify_structure()

    def test_from_edgelist(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text("0 1\n1 2\n")
        g = Graph.read_connectivity_from_edgelist_to_csr(str(p))
        assert g.n == 3 and g.m == 4  # undirected doubling


class TestPigoReaders:
    """Native parallel parse path (PIGO-equivalent); falls back to numpy
    when the toolchain is unavailable, so results must always match."""

    def test_pigo_mtx_matches_numpy(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_GENERAL)
        from sparsebase_tpu.io import PigoMTXReader

        a = PigoMTXReader(str(p)).read_coo()
        b = MTXReader(str(p)).read_coo()
        np.testing.assert_array_equal(np.asarray(a.row), np.asarray(b.row))
        np.testing.assert_array_equal(np.asarray(a.col), np.asarray(b.col))
        np.testing.assert_array_equal(np.asarray(a.vals), np.asarray(b.vals))

    def test_pigo_mtx_pattern(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(MTX_PATTERN)
        from sparsebase_tpu.io import PigoMTXReader

        coo = PigoMTXReader(str(p)).read_coo()
        assert coo.vals is None
        np.testing.assert_array_equal(coo.to_dense(), (fx.DENSE != 0).astype(np.int8))

    def test_pigo_edge_list_matches(self, tmp_path):
        p = tmp_path / "e.txt"
        p.write_text("0 1 0.5\n1 2 1.5\n% comment\n2 0 2.5\n")
        from sparsebase_tpu.io import EdgeListReader, PigoEdgeListReader

        a = PigoEdgeListReader(str(p), weighted=True, read_undirected=False).read_coo()
        b = EdgeListReader(str(p), weighted=True, read_undirected=False).read_coo()
        np.testing.assert_array_equal(np.asarray(a.row), np.asarray(b.row))
        np.testing.assert_allclose(np.asarray(a.vals), np.asarray(b.vals))

    def test_pigo_ash958(self):
        from sparsebase_tpu.bases import IOBase

        csr = IOBase.read_pigo_mtx_to_csr(fx.ASH958_SYM)
        ref = IOBase.read_mtx_to_csr(fx.ASH958_SYM)
        np.testing.assert_array_equal(np.asarray(csr.indptr), np.asarray(ref.indptr))
        np.testing.assert_array_equal(np.asarray(csr.indices), np.asarray(ref.indices))

    def test_scientific_notation(self, tmp_path):
        p = tmp_path / "m.mtx"
        p.write_text(
            "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.5e-3\n2 2 -2.25E+2\n"
        )
        from sparsebase_tpu.io import PigoMTXReader

        coo = PigoMTXReader(str(p)).read_coo()
        np.testing.assert_allclose(np.asarray(coo.vals), [1.5e-3, -225.0], rtol=1e-6)


class TestPigoDirectPath:
    """PigoMTXReader.read_coo's direct int64 fast path (no float64 body
    round trip) must match the generic reader on every coordinate
    flavor + flag combination (reference: io/pigo_mtx_reader.cc returns
    through the same COO semantics as MTXReader)."""

    CASES = {
        "pattern_general": "%%MatrixMarket matrix coordinate pattern general\n4 4 5\n1 2\n2 1\n3 4\n4 4\n2 3\n",
        "real_symmetric": "%%MatrixMarket matrix coordinate real symmetric\n4 4 4\n1 1 1.5\n2 1 -2\n3 2 0.5\n4 4 3\n",
        "integer_skew": "%%MatrixMarket matrix coordinate integer skew-symmetric\n4 4 3\n2 1 5\n3 1 2\n4 3 7\n",
    }

    @pytest.mark.parametrize("name", sorted(CASES))
    @pytest.mark.parametrize("upper", [False, True])
    def test_matches_generic(self, tmp_path, name, upper):
        from sparsebase_tpu.io import MTXReader, PigoMTXReader

        p = tmp_path / f"{name}.mtx"
        p.write_text(self.CASES[name])
        a = MTXReader(str(p), upper_triangle=upper).read_coo()
        b = PigoMTXReader(str(p), upper_triangle=upper).read_coo()
        np.testing.assert_array_equal(np.asarray(a.row), np.asarray(b.row))
        np.testing.assert_array_equal(np.asarray(a.col), np.asarray(b.col))
        if a.vals is None:
            assert b.vals is None
        else:
            np.testing.assert_allclose(np.asarray(a.vals), np.asarray(b.vals))
