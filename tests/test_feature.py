"""Feature extraction tests (parity: tests/suites/sparsebase/feature/* —
exact small-fixture values, fused extraction, auto-conversion)."""

import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO, CSC, CSR
from sparsebase_tpu.bases import GraphFeatureBase
from sparsebase_tpu.ops.feature import (
    AvgDegree,
    AvgDegreeColumn,
    Bandwidth,
    CoefficientOfVariationDegreeColumn,
    DegreeDistribution,
    Degrees,
    DegreesDegreeDistribution,
    FeatureExtractor,
    GeometricAvgDegreeColumn,
    JaccardWeights,
    MaxDegree,
    MaxDegreeColumn,
    MedianDegreeColumn,
    MinDegree,
    MinDegreeColumn,
    MinMaxAvgDegree,
    OffDiagBlockNNZ,
    Profile,
    StandardDeviationDegreeColumn,
    TriangleCount,
)


class TestRowFeatures:
    def test_degrees_fixture(self):
        np.testing.assert_array_equal(Degrees().get_degrees(fx.make_csr()), fx.DEGREES)

    def test_degrees_auto_convert(self):
        np.testing.assert_array_equal(Degrees().get_degrees(fx.make_coo()), fx.DEGREES)

    def test_degree_distribution_fixture(self):
        np.testing.assert_allclose(
            DegreeDistribution().get_distribution(fx.make_csr()), fx.DISTRIBUTION
        )

    def test_min_max_avg(self):
        csr = fx.make_csr()
        assert int(MinDegree().execute(None, csr)) == 1
        assert int(MaxDegree().execute(None, csr)) == 2
        assert float(AvgDegree().execute(None, csr)) == pytest.approx(4 / 3)

    def test_device(self):
        csr = fx.make_csr().to_device()
        np.testing.assert_array_equal(np.asarray(Degrees().get_degrees(csr)), fx.DEGREES)


class TestColumnFeatures:
    # column degrees of fixture: col0 has 2, col1 has 1, col2 has 1
    def test_min_max_avg_column(self):
        csc = fx.make_csc()
        assert int(MinDegreeColumn().execute(None, csc)) == 1
        assert int(MaxDegreeColumn().execute(None, csc)) == 2
        assert float(AvgDegreeColumn().execute(None, csc)) == pytest.approx(4 / 3)

    def test_auto_convert_from_csr(self):
        # CSR input must auto-convert to CSC
        assert int(MaxDegreeColumn().execute(None, fx.make_csr())) == 2

    def test_median(self):
        assert float(MedianDegreeColumn().execute(None, fx.make_csc())) == 1.0

    def test_std_reference_quirk(self):
        # reference: sqrt(sum((d-avg)^2)) without /n
        d = np.array([2, 1, 1])
        avg = 4 / 3
        expect = np.sqrt(((d - avg) ** 2).sum())
        assert float(
            StandardDeviationDegreeColumn().execute(None, fx.make_csc())
        ) == pytest.approx(expect)

    def test_coefficient_of_variation(self):
        d = np.array([2, 1, 1])
        avg = 4 / 3
        expect = np.sqrt(((d - avg) ** 2).sum()) / avg
        assert float(
            CoefficientOfVariationDegreeColumn().execute(None, fx.make_csc())
        ) == pytest.approx(expect)

    def test_geometric_avg(self):
        expect = np.exp(np.log([2, 1, 1]).sum() / 3)
        assert float(GeometricAvgDegreeColumn().execute(None, fx.make_csc())) == pytest.approx(
            expect, rel=1e-6
        )


class TestStructural:
    def test_bandwidth_fixture(self):
        # entries: (0,1)->2, (0,2)->3, (1,0)->2, (2,0)->3 => max 3
        assert int(Bandwidth().get_bandwidth(fx.make_csr())) == 3

    def test_bandwidth_empty(self):
        csr = CSR.new(np.zeros(4, np.int32), np.zeros(0, np.int32), shape=(3, 3))
        assert int(Bandwidth().get_bandwidth(csr)) == 0

    def test_profile_fixture(self):
        # row0: min(0,1)=0 -> 0; row1: min(1,0)=0 -> 1; row2: min(2,0)=0 -> 2
        assert int(Profile().get_profile(fx.make_csr())) == 3

    def test_offdiag_fixture(self):
        # 2x2 blocks on 3x3: rows {0,1},{2}; cols {0,1},{2}
        # entries (0,1) in-block, (0,2) off, (1,0) in, (2,0) off => 2
        assert int(OffDiagBlockNNZ(2, 2).get_off_diag_block_nnz(fx.make_csr())) == 2

    def test_offdiag_one_block(self):
        assert int(OffDiagBlockNNZ(1, 1).get_off_diag_block_nnz(fx.make_csr())) == 0

    def test_device(self):
        csr = fx.make_csr().to_device()
        assert int(np.asarray(Bandwidth().get_bandwidth(csr))) == 3
        assert int(np.asarray(Profile().get_profile(csr))) == 3


def _triangle_graph():
    # K3 plus a pendant vertex
    dense = np.array(
        [[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 1], [0, 0, 1, 0]], dtype=np.int32
    )
    r, c = np.nonzero(dense)
    return COO.new(r.astype(np.int32), c.astype(np.int32), None, shape=(4, 4)).convert(CSR)


class TestTriangleCount:
    def test_k3(self):
        assert TriangleCount().get_triangle_count(_triangle_graph()) == 1

    def test_k4(self):
        dense = 1 - np.eye(4, dtype=np.int32)
        r, c = np.nonzero(dense)
        g = COO.new(r.astype(np.int32), c.astype(np.int32), None, shape=(4, 4)).convert(CSR)
        assert TriangleCount().get_triangle_count(g) == 4

    def test_no_triangles(self):
        # path graph
        r = np.array([0, 1, 1, 2], np.int32)
        c = np.array([1, 0, 2, 1], np.int32)
        g = COO.new(r, c, None, shape=(3, 3)).convert(CSR)
        assert TriangleCount().get_triangle_count(g) == 0

    def test_directed_cycle(self):
        # directed 3-cycle: 0->1->2->0
        r = np.array([0, 1, 2], np.int32)
        c = np.array([1, 2, 0], np.int32)
        g = COO.new(r, c, None, shape=(3, 3)).convert(CSR)
        assert TriangleCount(count_directed=True).get_triangle_count(g) == 1
        assert TriangleCount(count_directed=False).get_triangle_count(g) == 0

    def test_random_vs_dense(self, rng):
        n = 30
        dense = (rng.random((n, n)) < 0.2).astype(np.int32)
        dense = np.triu(dense, 1)
        dense = dense + dense.T
        r, c = np.nonzero(dense)
        g = COO.new(r.astype(np.int32), c.astype(np.int32), None, shape=(n, n)).convert(CSR)
        expect = int(np.trace(dense @ dense @ dense) // 6)
        assert TriangleCount().get_triangle_count(g) == expect

    def test_duplicates_and_selfloops_set_semantics(self):
        # K3 with one duplicated edge and a self-loop: every path (host,
        # device dense, native) must count the simple graph — 1 triangle
        r = np.array([0, 1, 1, 2, 0, 2, 0, 1, 1], np.int32)
        c = np.array([1, 0, 2, 1, 2, 0, 1, 0, 1], np.int32)  # dup (0,1)/(1,0), loop (1,1)
        g = COO.new(r, c, None, shape=(3, 3), sort=True).convert(CSR)
        from sparsebase_tpu.ops.feature.triangles import (
            _device_dense_count,
            _undirected_count,
        )

        assert _undirected_count(g) == 1
        assert TriangleCount().get_triangle_count(g) == 1
        assert _device_dense_count(g.to_device(), False) == 1

    def test_device_exact_past_f32_range(self):
        # K_512: 6T = 133,432,320 > 2**24 — a bare f32 reduction drifts;
        # the wrapped-int32 + f32 reconstruction must stay exact
        # (ADVICE r2 high: ops/feature/triangles.py device path).
        n = 512
        dense = 1 - np.eye(n, dtype=np.int32)
        r, c = np.nonzero(dense)
        g = COO.new(r.astype(np.int32), c.astype(np.int32), None,
                    shape=(n, n)).convert(CSR)
        expect = n * (n - 1) * (n - 2) // 6  # C(512,3) = 22,238,720
        assert TriangleCount().get_triangle_count(g.to_device()) == expect

    def test_device_mxu_path(self, rng):
        # device CSR takes the dense matmul formulation; must agree with host
        n = 40
        dense = (rng.random((n, n)) < 0.15).astype(np.int32)
        np.fill_diagonal(dense, 0)
        sym = np.maximum(dense, dense.T)
        for d, directed in ((sym, False), (dense, True)):
            r, c = np.nonzero(d)
            g = COO.new(r.astype(np.int32), c.astype(np.int32), None,
                        shape=(n, n)).convert(CSR)
            host = TriangleCount(directed).get_triangle_count(g)
            dev = TriangleCount(directed).get_triangle_count(g.to_device())
            assert int(dev) == int(host)


class TestJaccard:
    def test_k3_pendant(self):
        g = _triangle_graph()
        w = np.asarray(JaccardWeights().get_jaccard_weights(g).vals)
        row = np.asarray(g.row_of_nnz())
        col = np.asarray(g.indices)
        # edge (0,1): N(0)={1,2}, N(1)={0,2} -> inter {2}=1, union {0,1,2}=3
        e01 = np.nonzero((row == 0) & (col == 1))[0][0]
        assert w[e01] == pytest.approx(1 / 3)
        # edge (2,3): N(2)={0,1,3}, N(3)={2} -> inter 0
        e23 = np.nonzero((row == 2) & (col == 3))[0][0]
        assert w[e23] == 0.0

    def test_symmetry(self, rng):
        n = 25
        dense = (rng.random((n, n)) < 0.25).astype(np.int32)
        dense = np.triu(dense, 1)
        dense = dense + dense.T
        r, c = np.nonzero(dense)
        g = COO.new(r.astype(np.int32), c.astype(np.int32), None, shape=(n, n)).convert(CSR)
        w = np.asarray(JaccardWeights().get_jaccard_weights(g).vals)
        lookup = {(int(a), int(b)): float(x) for a, b, x in zip(np.asarray(g.row_of_nnz()), np.asarray(g.indices), w)}
        for (a, b), x in lookup.items():
            assert lookup[(b, a)] == pytest.approx(x)

    def test_device_matches_host(self, rng):
        g = _triangle_graph()
        host = np.asarray(JaccardWeights().get_jaccard_weights(g).vals)
        dev = np.asarray(JaccardWeights().get_jaccard_weights(g.to_device()).vals)
        np.testing.assert_allclose(host, dev, rtol=1e-6)


def _rand_sym_csr(rng, n, avg_deg, self_loops=False, dups=False):
    e = n * avg_deg // 2
    r = rng.integers(0, n, e).astype(np.int64)
    c = rng.integers(0, n, e).astype(np.int64)
    if not self_loops:
        m = r != c
        r, c = r[m], c[m]
    rr = np.concatenate([r, c])
    cc = np.concatenate([c, r])
    if dups:
        rr = np.concatenate([rr, rr[: len(rr) // 4]])
        cc = np.concatenate([cc, cc[: len(cc) // 4]])
    return COO.new(rr.astype(np.int32), cc.astype(np.int32), None,
                   shape=(n, n)).convert(CSR)


class TestSparseDeviceTier:
    """Round-5: single-chip chunked owner-window kernel (sparse_common.py)
    — the big-n tier past the dense matmul wall / flat-expansion wall, the
    single-chip port of parallel/ring.py's sparse ring (VERDICT r4 #4)."""

    def test_triangles_sparse_matches_host(self, rng):
        from sparsebase_tpu.ops.feature.sparse_common import (
            triangle_count_sparse_device,
        )

        for seed, (sl, dup) in enumerate(
            [(False, False), (True, False), (False, True), (True, True)]
        ):
            g = _rand_sym_csr(np.random.default_rng(seed), 400, 10,
                              self_loops=sl, dups=dup)
            host = TriangleCount().get_triangle_count(g)
            dev = triangle_count_sparse_device(g.to_device())
            assert int(dev) == int(host), (seed, sl, dup)

    def test_triangles_impl_routes_past_dense_wall(self, rng, monkeypatch):
        # force the dense wall low so the dispatch itself takes the
        # sparse tier (the real wall is 16384 — too big for a unit test)
        import sparsebase_tpu.ops.feature.triangles as T

        monkeypatch.setattr(T, "MAX_DEVICE_DENSE_N", 100)
        g = _rand_sym_csr(rng, 500, 8)
        host = TriangleCount().get_triangle_count(g)
        dev = TriangleCount().get_triangle_count(g.to_device())
        assert int(dev) == int(host)

    def test_triangles_sparse_rejects_directed(self):
        from sparsebase_tpu.ops.feature.sparse_common import (
            triangle_count_sparse_device,
        )

        with pytest.raises(ValueError):
            triangle_count_sparse_device(_triangle_graph().to_device(),
                                         directed=True)

    def test_jaccard_sparse_matches_host(self, rng):
        from sparsebase_tpu.ops.feature.sparse_common import (
            jaccard_weights_sparse_device,
        )

        g = _rand_sym_csr(rng, 300, 12, self_loops=True)
        host = np.asarray(JaccardWeights().get_jaccard_weights(g).vals)
        dev = np.asarray(jaccard_weights_sparse_device(g.to_device()))
        np.testing.assert_allclose(host, dev, rtol=1e-6)

    def test_jaccard_impl_routes_past_expansion_wall(self, rng, monkeypatch):
        import sparsebase_tpu.ops.feature.jaccard as J

        monkeypatch.setattr(J, "MAX_FLAT_EXPANSION", 10)
        g = _rand_sym_csr(rng, 200, 8)
        host = np.asarray(JaccardWeights().get_jaccard_weights(g).vals)
        dev = np.asarray(
            JaccardWeights().get_jaccard_weights(g.to_device()).vals
        )
        np.testing.assert_allclose(host, dev, rtol=1e-6)

    def test_triangles_sparse_empty_and_hub(self):
        from sparsebase_tpu.ops.feature.sparse_common import (
            triangle_count_sparse_device,
        )

        empty = COO.new(np.empty(0, np.int32), np.empty(0, np.int32), None,
                        shape=(5, 5)).convert(CSR)
        assert triangle_count_sparse_device(empty.to_device()) == 0
        # star + one cross edge: hub degree n-1, exactly 1 triangle
        n = 300
        r = np.concatenate([np.zeros(n - 1), np.arange(1, n), [1, 2]])
        c = np.concatenate([np.arange(1, n), np.zeros(n - 1), [2, 1]])
        g = COO.new(r.astype(np.int32), c.astype(np.int32), None,
                    shape=(n, n)).convert(CSR)
        assert triangle_count_sparse_device(g.to_device()) == 1


class TestFusedExtraction:
    def test_fused_degrees_distribution(self):
        out = DegreesDegreeDistribution().extract(fx.make_csr())
        np.testing.assert_array_equal(out[Degrees], fx.DEGREES)
        np.testing.assert_allclose(out[DegreeDistribution], fx.DISTRIBUTION)

    def test_fused_min_max_avg(self):
        out = MinMaxAvgDegree().extract(fx.make_csr())
        assert set(out) == {MinDegree, MaxDegree, AvgDegree}
        assert int(out[MinDegree]) == 1 and int(out[MaxDegree]) == 2

    def test_extractor_fuses(self):
        ex = FeatureExtractor()
        out = ex.extract(fx.make_csr(), features=[Degrees, DegreeDistribution])
        assert set(out) == {Degrees, DegreeDistribution}
        np.testing.assert_array_equal(out[Degrees], fx.DEGREES)

    def test_extractor_mixed(self):
        ex = FeatureExtractor()
        out = ex.extract(fx.make_csr(), features=[Bandwidth, MinDegree, MaxDegree, AvgDegree])
        assert int(out[Bandwidth]) == 3
        assert int(out[MinDegree]) == 1

    def test_extractor_add_subtract(self):
        ex = FeatureExtractor()
        d = Degrees()
        ex.add(d)
        assert ex.get_list() == [Degrees]
        ex.subtract(d)
        assert ex.get_list() == []

    def test_facade(self):
        np.testing.assert_array_equal(GraphFeatureBase.get_degrees(fx.make_csr()), fx.DEGREES)
        np.testing.assert_allclose(
            GraphFeatureBase.get_degree_distribution(fx.make_coo()), fx.DISTRIBUTION
        )
        out = GraphFeatureBase.extract([Degrees, Bandwidth], fx.make_coo())
        assert set(out) == {Degrees, Bandwidth}
