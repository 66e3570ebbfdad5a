"""Distributed-layer tests on the virtual 8-device CPU mesh.

The reference has no distributed tests (SURVEY.md §4); these cover the
Multi-device layer: sharded containers + shard_map collectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO, CSR
from sparsebase_tpu.parallel import (
    ShardedCSR,
    bfs_levels,
    degree_reorder,
    degrees,
    label_prop_partition,
    make_mesh,
    spmv,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def random_csr(rng, n=64, avg_deg=5, with_vals=True):
    nnz = n * avg_deg
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    keys = np.unique(row.astype(np.int64) * n + col)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    vals = rng.standard_normal(len(row)).astype(np.float32) if with_vals else None
    from sparsebase_tpu.convert import coo_to_csr

    return coo_to_csr(COO.new(row, col, vals, shape=(n, n)))


class TestShardedCSR:
    def test_roundtrip(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh)
        assert sh.n_shards == 8
        assert sh.nnz == csr.nnz
        back = sh.to_csr()
        np.testing.assert_array_equal(np.asarray(back.indptr), np.asarray(csr.indptr))
        np.testing.assert_array_equal(np.asarray(back.indices), np.asarray(csr.indices))
        np.testing.assert_allclose(np.asarray(back.vals), np.asarray(csr.vals))

    def test_roundtrip_fixture(self, mesh):
        sh = ShardedCSR.from_csr(fx.make_csr(), mesh)
        back = sh.to_csr()
        fx.compare_csr(fx.make_csr(), back)

    def test_sharding_layout(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh)
        assert len(sh.indices.sharding.device_set) == 8


class TestDistributedOps:
    def test_spmv_matches_dense(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh)
        x = rng.standard_normal(csr.ncols).astype(np.float32)
        y = np.asarray(spmv(sh, jnp.asarray(x), mesh))
        ref = np.asarray(csr.to_dense()) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)

    def test_degrees(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh)
        d = np.asarray(degrees(sh, mesh))
        np.testing.assert_array_equal(d, np.diff(np.asarray(csr.indptr)))

    def test_bfs_levels_path(self, mesh):
        # path graph 0-1-2-...-15: level of v = v
        n = 16
        row = np.concatenate([np.arange(n - 1), np.arange(1, n)]).astype(np.int32)
        col = np.concatenate([np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
        from sparsebase_tpu.convert import coo_to_csr

        csr = coo_to_csr(COO.new(row, col, None, shape=(n, n)))
        # pattern matrix: give unit vals for sharding (vals=None ok too)
        sh = ShardedCSR.from_csr(csr, mesh)
        levels = np.asarray(bfs_levels(sh, 0, mesh))
        np.testing.assert_array_equal(levels, np.arange(n))

    def test_bfs_disconnected(self, mesh):
        n = 8
        row = np.array([0, 1], np.int32)
        col = np.array([1, 0], np.int32)
        from sparsebase_tpu.convert import coo_to_csr

        csr = coo_to_csr(COO.new(row, col, None, shape=(n, n)))
        sh = ShardedCSR.from_csr(csr, mesh)
        levels = np.asarray(bfs_levels(sh, 0, mesh))
        assert levels[0] == 0 and levels[1] == 1
        assert (levels[2:] == -1).all()

    def test_degree_reorder(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh)
        order = np.asarray(degree_reorder(sh, mesh))
        fx.check_degree_ordering(order, np.asarray(csr.indptr))

    def test_label_prop_partition(self, mesh, rng):
        csr = random_csr(rng, n=64, avg_deg=6)
        sh = ShardedCSR.from_csr(csr, mesh)
        labels = np.asarray(label_prop_partition(sh, 4, mesh, num_iters=8))
        fx.check_partition(labels, 64, 4)

    def test_spmv_jit_pipeline(self, mesh, rng):
        # whole pipeline under one jit: spmv twice (power-iteration style)
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh)

        @jax.jit
        def two_step(s, x):
            y = spmv(s, x, mesh)
            return spmv(s, y / (jnp.linalg.norm(y) + 1e-6), mesh)

        out = np.asarray(two_step(sh, jnp.ones(csr.ncols, jnp.float32)))
        assert out.shape == (csr.nrows,)
        assert np.isfinite(out).all()

    def test_distributed_rcm(self, mesh):
        # path graph: RCM should produce a monotone (reversed-BFS) order
        n = 32
        row = np.concatenate([np.arange(n - 1), np.arange(1, n)]).astype(np.int32)
        col = np.concatenate([np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
        from sparsebase_tpu.convert import coo_to_csr
        from sparsebase_tpu.parallel import rcm_reorder

        csr = coo_to_csr(COO.new(row, col, None, shape=(n, n)))
        sh = ShardedCSR.from_csr(csr, mesh)
        order = np.asarray(rcm_reorder(sh, mesh, root=0))
        fx.check_reorder(order, n)
        # bandwidth of the path under this order must stay 1
        bw = np.abs(order[row.astype(int)] - order[col.astype(int)]).max()
        assert bw == 1

    def test_distributed_rcm_disconnected(self, mesh, rng):
        csr = random_csr(rng, n=48, avg_deg=2, with_vals=False)
        from sparsebase_tpu.parallel import rcm_reorder

        sh = ShardedCSR.from_csr(csr, mesh)
        order = np.asarray(rcm_reorder(sh, mesh, root=0))
        fx.check_reorder(order, 48)


class TestWeakScaling:
    def test_harness_runs(self):
        from sparsebase_tpu.parallel.scaling import run_weak_scaling

        out = run_weak_scaling(base_n=256, avg_deg=4, device_counts=[1, 2, 4], reps=1)
        assert set(out) == {1, 2, 4}
        for d, r in out.items():
            assert r["n"] == 256 * d
            assert r["spmv_s"] > 0
        assert out[1]["spmv_efficiency"] == 1.0


class TestRefinePartition:
    def test_reduces_edge_cut(self, mesh, rng):
        from sparsebase_tpu.parallel import edge_cut, refine_partition

        csr = random_csr(rng, n=96, avg_deg=6)
        sh = ShardedCSR.from_csr(csr, mesh)
        k = 4
        labels0 = jnp.asarray((np.arange(96) * k // 96).astype(np.int32))
        # scramble a third of the labels so there is something to refine
        scr = rng.integers(0, 96, 32)
        labels0 = labels0.at[scr].set(jnp.asarray(rng.integers(0, k, 32), jnp.int32))
        cut0 = int(edge_cut(sh, labels0, mesh))
        labels1 = refine_partition(sh, labels0, k, mesh, rounds=4)
        cut1 = int(edge_cut(sh, labels1, mesh))
        assert labels1.shape == (96,)
        assert int(jnp.max(labels1)) < k and int(jnp.min(labels1)) >= 0
        assert cut1 <= cut0, (cut0, cut1)
        # balance: no part exceeds the cap by more than one round's drift
        sizes = np.bincount(np.asarray(labels1), minlength=k)
        assert sizes.max() <= 1.3 * 96 / k

    def test_edge_cut_matches_host(self, mesh, rng):
        from sparsebase_tpu.parallel import edge_cut

        csr = random_csr(rng, n=64, avg_deg=5)
        sh = ShardedCSR.from_csr(csr, mesh)
        labels = jnp.asarray(rng.integers(0, 3, 64).astype(np.int32))
        got = int(edge_cut(sh, labels, mesh))
        lab = np.asarray(labels)
        row = np.repeat(np.arange(64), np.diff(np.asarray(csr.indptr)))
        want = int((lab[row] != lab[np.asarray(csr.indices)]).sum())
        assert got == want


class TestStructureFeatures:
    def test_matches_host_features(self, mesh, rng):
        from sparsebase_tpu.ops.feature import Bandwidth, Profile
        from sparsebase_tpu.parallel import structure_features

        csr = random_csr(rng, n=80, avg_deg=4)
        sh = ShardedCSR.from_csr(csr, mesh)
        feats = structure_features(sh, mesh)
        assert int(feats["nnz"]) == csr.nnz
        assert int(feats["bandwidth"]) == int(Bandwidth().get_bandwidth(csr))
        assert int(feats["profile"]) == int(Profile().get_profile(csr))
        deg = np.diff(np.asarray(csr.indptr))
        assert int(feats["min_degree"]) == int(deg.min())
        assert int(feats["max_degree"]) == int(deg.max())
        assert abs(float(feats["avg_degree"]) - deg.mean()) < 1e-5


class TestDistributedHeatmap:
    def test_matches_host_heatmap(self, mesh, rng):
        from sparsebase_tpu.bases import ReorderBase
        from sparsebase_tpu.parallel.dist import reorder_heatmap

        csr = random_csr(rng, n=64, avg_deg=5)
        sh = ShardedCSR.from_csr(csr, mesh)
        ident = np.arange(64, dtype=np.int32)
        got = np.asarray(reorder_heatmap(sh, ident, ident, mesh, num_parts=4))
        want = np.asarray(
            ReorderBase.heatmap(csr, ident, ident, num_parts=4).vals
        ).reshape(4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_reordered(self, mesh, rng):
        from sparsebase_tpu.bases import ReorderBase
        from sparsebase_tpu.ops.reorder import DegreeReorder
        from sparsebase_tpu.parallel.dist import reorder_heatmap

        csr = random_csr(rng, n=48, avg_deg=4)
        sh = ShardedCSR.from_csr(csr, mesh)
        order = np.asarray(DegreeReorder().get_reorder(csr)).astype(np.int32)
        got = np.asarray(reorder_heatmap(sh, order, order, mesh, num_parts=3))
        want = np.asarray(
            ReorderBase.heatmap(csr, order, order, num_parts=3).vals
        ).reshape(3, 3)
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestMultihost:
    def test_single_process_degenerates(self):
        from sparsebase_tpu.parallel import multihost

        # single-process: initialize is a no-op returning False, the
        # global mesh covers the local devices, and this process owns
        # the whole entry list
        assert multihost.initialize() is False
        mesh = multihost.global_mesh()
        import jax

        assert mesh.size == len(jax.devices())
        start, count = multihost.local_entry_counts(1000)
        assert (start, count) == (0, 1000)


class TestBalancedSharding:
    """nnz-balanced row blocks via the serpentine degree deal (VERDICT r2
    item 3): on row-skewed graphs the padded width must stop following
    the worst shard; the balancing is a layout permutation, so every
    sharded kernel runs unchanged on the balanced container."""

    def _zipf_csr(self, n=20000, nz=200000, seed=1):
        from sparsebase_tpu.convert import coo_to_csr

        rng = np.random.default_rng(seed)
        zr = rng.zipf(1.3, nz) - 1
        zr = zr[zr < n].astype(np.int64)
        zc = rng.integers(0, n, len(zr)).astype(np.int64)
        keys = np.unique(zr * n + zc)
        return coo_to_csr(COO.new(
            (keys // n).astype(np.int32), (keys % n).astype(np.int32), None,
            shape=(n, n)))

    def test_order_valid_and_balanced(self, mesh):
        from sparsebase_tpu.parallel.sharded import balanced_row_order

        csr = self._zipf_csr()
        order = balanced_row_order(csr, 8)
        assert sorted(order.tolist()) == list(range(csr.nrows))
        sh0 = ShardedCSR.from_csr(csr, mesh, halo=False)
        sh1, order2 = ShardedCSR.from_csr_balanced(csr, mesh, halo=False)
        np.testing.assert_array_equal(order, order2)
        assert sh0.padded_width_ratio() > 2.5  # skew really present
        assert sh1.padded_width_ratio() <= 2.0  # the item-3 criterion
        assert sh1.nnz == csr.nnz

    def test_host_fetch_allgather_fallback(self, mesh, monkeypatch):
        # multihost runs raise RuntimeError from device_get on
        # non-addressable shards; _host_fetch must fall back to
        # process_allgather (MULTIPROC r4). Simulate the raise.
        import jax

        from sparsebase_tpu.parallel import sharded as sh_mod

        x = jax.device_put(
            np.arange(16, dtype=np.int32),
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x")),
        )
        direct = sh_mod._host_fetch(x)
        np.testing.assert_array_equal(direct, np.arange(16))

        def boom(_):
            raise RuntimeError("spans non-addressable devices")

        monkeypatch.setattr(jax, "device_get", boom)
        fallback = sh_mod._host_fetch(x)
        np.testing.assert_array_equal(np.asarray(fallback).reshape(-1), np.arange(16))

    def test_tail_alignment_when_n_not_divisible(self):
        # n % d != 0: dealt blocks must coincide with the fixed
        # ceil(n/d) shard boundaries (ADVICE r3: the old rank compaction
        # shifted up to d-1 rows across shards). Every non-tail shard
        # must hold exactly `rows` rows and nnz stays balanced.
        from sparsebase_tpu.parallel.sharded import balanced_row_order

        d = 8
        csr = self._zipf_csr(n=20005, nz=200000, seed=2)
        n = csr.nrows
        order = balanced_row_order(csr, d)
        assert sorted(order.tolist()) == list(range(n))
        rows = -(-n // d)
        deg = np.diff(np.asarray(csr.indptr))
        shard_of_new = np.minimum(np.arange(n) // rows, d - 1)
        shard_nnz = np.bincount(shard_of_new[order], weights=deg, minlength=d)
        counts = np.bincount(shard_of_new[order], minlength=d)
        assert (counts[:-1] == rows).all()
        assert counts[-1] == n - (d - 1) * rows
        mean = deg.sum() / d
        # same <=2 criterion as the padded-width gate; the head zipf row
        # alone sets the max for any contiguous-block deal
        assert shard_nnz.max() <= 2.0 * mean

    def test_halo_kernels_green_on_balanced(self, mesh, rng):
        import scipy.sparse as sp

        from sparsebase_tpu.parallel import dist, halo

        csr = self._zipf_csr(n=4000, nz=40000, seed=3)
        sh, order = ShardedCSR.from_csr_balanced(csr, mesh, halo=True)
        n = csr.nrows
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(halo.spmv(sh, jnp.asarray(x), mesh))
        pc = sh.to_csr()
        m = sp.csr_matrix(
            (np.ones(pc.nnz, np.float32), np.asarray(pc.indices),
             np.asarray(pc.indptr)), shape=(n, n))
        np.testing.assert_allclose(y, m @ x, rtol=1e-3, atol=1e-3)
        # degrees of the permuted container map back through the order
        deg_new = np.asarray(dist.degrees(sh, mesh))
        deg_old = np.diff(np.asarray(csr.indptr))
        np.testing.assert_array_equal(deg_new[order], deg_old)
