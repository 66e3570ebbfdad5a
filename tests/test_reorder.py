"""Reorder + permute tests (parity: tests/suites/sparsebase/reorder/*,
permute/*, bases/reorder_base_tests.cc)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO, CSC, CSR, DenseArray
from sparsebase_tpu.bases import IOBase, ReorderBase
from sparsebase_tpu.ops.permute import (
    PermuteOrderOne,
    PermuteOrderTwo,
    inverse_permutation,
    permute_1d,
    permute_2d,
)
from sparsebase_tpu.ops.reorder import (
    BOBAReorder,
    DegreeReorder,
    GenericReorder,
    GrayReorder,
    RCMReorder,
    ReorderHeatmap,
    SlashburnReorder,
)


def _random_graph(rng, n=60, avg_deg=5, symmetric=True):
    nnz = n * avg_deg
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    if symmetric:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
    keep = row != col
    row, col = row[keep], col[keep]
    keys = row.astype(np.int64) * n + col
    uniq = np.unique(keys)
    row = (uniq // n).astype(np.int32)
    col = (uniq % n).astype(np.int32)
    from sparsebase_tpu.convert import coo_to_csr

    return coo_to_csr(COO.new(row, col, None, shape=(n, n)))


def bandwidth_of(csr, order=None):
    row = np.asarray(csr.row_of_nnz())
    col = np.asarray(csr.indices)
    if order is not None:
        order = np.asarray(order)
        row, col = order[row], order[col]
    return int(np.abs(row.astype(np.int64) - col).max(initial=0))


class TestDegreeReorder:
    def test_fixture_ascending(self):
        order = DegreeReorder(ascending=True).get_reorder(fx.make_csr())
        fx.check_degree_ordering(order, fx.ROW_PTR, ascending=True)

    def test_fixture_descending(self):
        order = DegreeReorder(ascending=False).get_reorder(fx.make_csr())
        fx.check_degree_ordering(order, fx.ROW_PTR, ascending=False)

    def test_auto_convert_from_coo(self):
        order = DegreeReorder().get_reorder(fx.make_coo())
        fx.check_reorder(order, fx.N)

    def test_device(self):
        csr = fx.make_csr().to_device()
        order = DegreeReorder(ascending=True).get_reorder(csr)
        fx.check_degree_ordering(np.asarray(order), fx.ROW_PTR, ascending=True)

    def test_random(self, rng):
        csr = _random_graph(rng)
        order = DegreeReorder().get_reorder(csr)
        fx.check_degree_ordering(order, np.asarray(csr.indptr))


class TestRCM:
    def test_fixture(self):
        order = RCMReorder().get_reorder(fx.make_csr())
        fx.check_reorder(np.asarray(order), fx.N)

    def test_from_coo_autoconvert(self):
        # parity: rcm_reorder_tests.cc:21-25 (COO forces auto-convert)
        order = RCMReorder().get_reorder(fx.make_coo())
        fx.check_reorder(np.asarray(order), fx.N)

    def test_reduces_bandwidth_random(self, rng):
        csr = _random_graph(rng, n=120, avg_deg=3)
        order = RCMReorder().get_reorder(csr)
        fx.check_reorder(order, csr.nrows)
        assert bandwidth_of(csr, order) <= bandwidth_of(csr)

    def test_ash958_bandwidth(self):
        # the square symmetric pattern graph of the rectangular matrix
        g = IOBase.read_mtx_to_csr(fx.ASH958_SYM)
        n = g.nrows
        order = RCMReorder().get_reorder(g)
        fx.check_reorder(order, n)
        bw0, bw1 = bandwidth_of(g), bandwidth_of(g, order)
        assert bw1 < bw0
        # quality parity: within 25% of scipy's reference RCM
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        A = sp.csr_matrix(
            (np.ones(g.nnz), np.asarray(g.indices), np.asarray(g.indptr)), shape=(n, n)
        )
        ref = np.argsort(reverse_cuthill_mckee(A, symmetric_mode=True))
        assert bw1 <= bandwidth_of(g, ref) * 1.25

    def test_device_matches_validity(self, rng):
        csr = _random_graph(rng, n=64, avg_deg=4)
        order = RCMReorder().get_reorder(csr.to_device())
        order = np.asarray(order)
        fx.check_reorder(order, csr.nrows)
        assert bandwidth_of(csr, order) <= bandwidth_of(csr)

    def test_disconnected(self):
        # two disjoint edges + isolated vertex
        indptr = np.array([0, 1, 2, 3, 4, 4], np.int32)
        indices = np.array([1, 0, 3, 2], np.int32)
        csr = CSR.new(indptr, indices, None, shape=(5, 5))
        order = RCMReorder().get_reorder(csr)
        fx.check_reorder(order, 5)


class TestGray:
    def test_fixture(self):
        order = GrayReorder(resolution=3, nnz_threshold=1, sparse_density_group_size=2).get_reorder(
            fx.make_csr()
        )
        fx.check_reorder(np.asarray(order), fx.N)

    def test_random(self, rng):
        csr = _random_graph(rng, n=100, avg_deg=6)
        order = GrayReorder(resolution=16, nnz_threshold=4).get_reorder(csr)
        fx.check_reorder(np.asarray(order), csr.nrows)

    def test_device(self, rng):
        csr = _random_graph(rng, n=50, avg_deg=4).to_device()
        order = GrayReorder(resolution=16).get_reorder(csr)
        fx.check_reorder(np.asarray(order), 50)


class TestBOBA:
    def test_fixture(self):
        order = BOBAReorder().get_reorder(fx.make_coo())
        fx.check_reorder(np.asarray(order), fx.N)

    def test_first_seen_order(self):
        # entries sorted by (col,row): (1,0),(2,0),(0,1),(0,2)
        # rows seq: 1,2,0,0 -> first seen rows 1,2,0; cols seq: 0,0,1,2
        # vertex first-appearance: v1@0, v2@1, v0@2 -> order v1,v2,v0
        order = np.asarray(BOBAReorder().get_reorder(fx.make_coo()))
        np.testing.assert_array_equal(order, [2, 0, 1])

    def test_isolated_last(self):
        coo = COO.new(
            np.array([0], np.int32), np.array([1], np.int32), None, shape=(4, 4)
        )
        order = np.asarray(BOBAReorder().get_reorder(coo))
        fx.check_reorder(order, 4)
        assert order[2] > order[0] and order[3] > order[0]

    def test_random(self, rng):
        csr = _random_graph(rng)
        order = BOBAReorder().get_reorder(csr)  # auto-convert CSR->COO
        fx.check_reorder(np.asarray(order), csr.nrows)


class TestSlashburn:
    def test_fixture(self):
        order = SlashburnReorder(k_size=1).get_reorder(fx.make_csr())
        fx.check_reorder(np.asarray(order), fx.N)

    def test_random(self, rng):
        csr = _random_graph(rng, n=80, avg_deg=4)
        for greedy in (False, True):
            for hub_order in (False, True):
                order = SlashburnReorder(
                    k_size=4, greedy=greedy, hub_order=hub_order
                ).get_reorder(csr)
                fx.check_reorder(np.asarray(order), csr.nrows)

    def test_hubs_first(self, rng):
        # star graph: center is the hub, must be position 0
        n = 20
        row = np.concatenate([np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)])
        col = np.concatenate([np.arange(1, n, dtype=np.int32), np.zeros(n - 1, np.int32)])
        csr = COO.new(row, col, None, shape=(n, n)).convert(CSR)
        order = np.asarray(SlashburnReorder(k_size=2).get_reorder(csr))
        assert order[0] == 0


class TestGenericReorder:
    def test_user_registered(self):
        op = GenericReorder()
        op.register((CSR,), lambda f, p: np.arange(f[0].nrows, dtype=np.int32)[::-1].copy())
        order = op.get_reorder(fx.make_csr())
        np.testing.assert_array_equal(order, [2, 1, 0])


class TestPermute:
    def test_permute2d_rows_fixture(self):
        out = ReorderBase.permute2d_rowwise(fx.R_REORDER, fx.make_csr())
        np.testing.assert_array_equal(np.asarray(out.indptr), fx.R_ROW_PTR)
        np.testing.assert_array_equal(np.asarray(out.indices), fx.R_COLS)
        np.testing.assert_array_equal(np.asarray(out.vals), fx.R_VALS)

    def test_permute2d_cols_fixture(self):
        out = ReorderBase.permute2d_colwise(fx.C_REORDER, fx.make_csr())
        np.testing.assert_array_equal(np.asarray(out.indptr), fx.C_ROW_PTR)
        np.testing.assert_array_equal(np.asarray(out.indices), fx.C_COLS)
        np.testing.assert_array_equal(np.asarray(out.vals), fx.C_VALS)

    def test_permute2d_rowcol_fixture(self):
        out = ReorderBase.permute2d_row_columnwise(fx.R_REORDER, fx.C_REORDER, fx.make_csr())
        np.testing.assert_array_equal(np.asarray(out.indptr), fx.RC_ROW_PTR)
        np.testing.assert_array_equal(np.asarray(out.indices), fx.RC_COLS)
        np.testing.assert_array_equal(np.asarray(out.vals), fx.RC_VALS)

    def test_permute1d_fixture(self):
        arr = DenseArray.new(fx.ORIGINAL_ARRAY.copy())
        out = ReorderBase.permute1d(fx.INV_PERM_ARRAY, arr)
        np.testing.assert_allclose(np.asarray(out.vals), fx.REORDERED_ARRAY)

    def test_inverse_permutation(self):
        inv = inverse_permutation(fx.PERM_ARRAY)
        np.testing.assert_array_equal(inv, fx.INV_PERM_ARRAY)
        inv2 = ReorderBase.inverse_permutation(inv)
        np.testing.assert_array_equal(inv2, fx.PERM_ARRAY)

    def test_permute_coo(self):
        out = permute_2d(fx.make_coo(), fx.R_REORDER, fx.C_REORDER)
        assert isinstance(out, COO)
        expect = np.zeros((3, 3), np.int32)
        d = fx.DENSE
        for i in range(3):
            for j in range(3):
                expect[fx.R_REORDER[i], fx.C_REORDER[j]] = d[i, j]
        np.testing.assert_array_equal(out.to_dense(), expect)

    def test_permute_structure_preserved_random(self, rng):
        csr = _random_graph(rng, n=40)
        order = np.asarray(RCMReorder().get_reorder(csr))
        out = ReorderBase.permute2d(order, csr)
        fx.confirm_renumbered_csr(
            np.asarray(csr.indptr),
            np.asarray(csr.indices),
            np.asarray(out.indptr),
            np.asarray(out.indices),
            order,
        )

    def test_permute_on_device_jit(self, rng):
        csr = _random_graph(rng, n=32).to_device()
        order = jnp.argsort(csr.indptr[1:] - csr.indptr[:-1])

        @jax.jit
        def pipeline(c, o):
            from sparsebase_tpu.ops.permute import _permute_csr, PermuteOrderTwoParams

            return _permute_csr([c], PermuteOrderTwoParams(o, o))

        out = pipeline(csr, order)
        host = out.to_host()
        fx.check_reorder(np.asarray(jnp.argsort(order)), 32)
        assert host.nnz == csr.nnz


class TestHeatmap:
    def test_fixture_natural(self):
        ident = np.arange(3, dtype=np.int32)
        heat = ReorderBase.heatmap(fx.make_csr(), ident, ident, num_parts=3)
        np.testing.assert_allclose(
            np.asarray(heat.vals).reshape(3, 3), fx.HEATMAP_NO_ORDER
        )

    def test_fixture_reordered(self):
        heat = ReorderBase.heatmap(fx.make_csr(), fx.R_REORDER, fx.C_REORDER, num_parts=3)
        np.testing.assert_allclose(
            np.asarray(heat.vals).reshape(3, 3), fx.HEATMAP_RC_ORDER
        )

    def test_too_many_parts_raises(self):
        from sparsebase_tpu.utils.exceptions import ReorderError

        ident = np.arange(3, dtype=np.int32)
        with pytest.raises(ReorderError):
            ReorderBase.heatmap(fx.make_csr(), ident, ident, num_parts=5)

    def test_fused_stats(self):
        # fixture: 3x3, nnz=4 at (0,0),(0,2),(1,1),(2,2) under natural order
        ident = np.arange(3, dtype=np.int32)
        heat, stats = ReorderBase.heatmap_with_stats(
            fx.make_csr(), ident, ident, num_parts=3
        )
        np.testing.assert_allclose(
            np.asarray(heat.vals).reshape(3, 3), fx.HEATMAP_NO_ORDER
        )
        # entries (0,1),(0,2),(1,0),(2,0): bandwidths 1,2,1,2 → mean 1.5,
        # max 2; 4 nonempty 1x1 blocks; block bw equals entry bw here
        assert stats["max_bw"] == 2
        np.testing.assert_allclose(stats["mean_bw"], 1.5)
        assert stats["num_full_blocks"] == 4
        np.testing.assert_allclose(stats["block_mean_bw"], 1.5)


class TestReorderBaseFacade:
    def test_reorder(self):
        order = ReorderBase.reorder(DegreeReorder, fx.make_csr())
        fx.check_reorder(np.asarray(order), fx.N)

    def test_reorder_with_params(self):
        order = ReorderBase.reorder(DegreeReorder, fx.make_csr(), params={"ascending": False})
        fx.check_degree_ordering(np.asarray(order), fx.ROW_PTR, ascending=False)

    def test_reorder_cached(self):
        converted, order = ReorderBase.reorder_cached(DegreeReorder, fx.make_coo())
        assert isinstance(converted[0], CSR)
        fx.check_reorder(np.asarray(order), fx.N)

    def test_permute2d_cached(self):
        # Permute2DCached parity (reorder_base.h:196): returns the
        # conversions actually run + the permuted format
        order = np.arange(fx.N)[::-1].copy()
        inter, out = ReorderBase.permute2d_cached(order, fx.make_csr())
        assert isinstance(out, CSR)
        direct = ReorderBase.permute2d(order, fx.make_csr())
        np.testing.assert_array_equal(np.asarray(out.indptr), np.asarray(direct.indptr))
        np.testing.assert_array_equal(np.asarray(out.indices), np.asarray(direct.indices))

    def test_permute1d_cached(self):
        from sparsebase_tpu.formats.array import DenseArray

        order = np.array([2, 0, 1])
        inter, out = ReorderBase.permute1d_cached(order, DenseArray.new(np.array([10.0, 20.0, 30.0])))
        # order[old] = new: element 0 -> slot 2, 1 -> 0, 2 -> 1
        np.testing.assert_array_equal(np.asarray(out.vals), [20.0, 30.0, 10.0])


class TestDeviceRCMNoSizeKnob:
    def test_device_rcm_has_no_size_limit(self):
        """Device RCM takes any device input: the config has no size
        knob, and the reorderer runs on the device (no host fallback)
        with the same validity as the host path."""
        import dataclasses

        from sparsebase_tpu import get_config
        from sparsebase_tpu.ops.reorder.rcm import _rcm_device

        assert not [f.name for f in dataclasses.fields(get_config()) if "max_n" in f.name]
        g = fx.make_csr()
        order = RCMReorder().get_reorder(g.to_device())
        assert not isinstance(order, np.ndarray)  # computed on the device
        assert sorted(np.asarray(order).tolist()) == list(range(g.nrows))
        assert sorted(np.asarray(_rcm_device(g.to_device())).tolist()) == list(range(g.nrows))
