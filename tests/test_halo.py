"""Halo-exchange kernel tests: equivalence with the dense psum path and
boundary-proportional communication (VERDICT round-1 item 2).

The reference has no distributed layer (SURVEY.md §2.13) — these cover
Multi-device work on the virtual 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO
from sparsebase_tpu.convert import coo_to_csr
from sparsebase_tpu.parallel import ShardedCSR, dist, halo, make_mesh


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.fixture(scope="module")
def mesh2d():
    from sparsebase_tpu.parallel import make_mesh_2d

    assert len(jax.devices()) >= 8
    return make_mesh_2d((4, 2))


def random_csr(rng, n=64, avg_deg=5, with_vals=True):
    nnz = n * avg_deg
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    keys = np.unique(row.astype(np.int64) * n + col)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    vals = rng.standard_normal(len(row)).astype(np.float32) if with_vals else None
    return coo_to_csr(COO.new(row, col, vals, shape=(n, n)))


def path_csr(n):
    row = np.concatenate([np.arange(n - 1), np.arange(1, n)]).astype(np.int32)
    col = np.concatenate([np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
    return coo_to_csr(COO.new(row, col, None, shape=(n, n)))


class TestDeviceHaloBuilder:
    """with_halo() now builds halo metadata on the mesh (sort + run-head
    dedup + one all_to_all of request lists, VERDICT r2 item 2); the host
    d²/np.unique pass (_build_halo) is the oracle."""

    @pytest.mark.parametrize("seed,n,deg", [(0, 64, 5), (1, 40, 3), (2, 96, 7),
                                            (3, 17, 2), (4, 8, 1)])
    def test_matches_host_builder(self, mesh, seed, n, deg):
        from sparsebase_tpu.parallel.sharded import _build_halo

        rng = np.random.default_rng(seed)
        csr = random_csr(rng, n=n, avg_deg=deg)
        base = ShardedCSR.from_csr(csr, mesh, halo=False)
        dev = base.with_halo()
        li = np.asarray(jax.device_get(base.indices))
        nl = np.asarray(jax.device_get(base.nnz_local)).astype(np.int64)
        hs, hc, hm = _build_halo(li, nl, base.rows_per_shard, base.n_shards)
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(dev.halo_counts)), hc
        )
        got_hs = np.asarray(jax.device_get(dev.halo_send))
        got_hm = np.asarray(jax.device_get(dev.halo_map))
        assert got_hs.shape == hs.shape  # same padded S (max pair count)
        np.testing.assert_array_equal(got_hs, hs)
        np.testing.assert_array_equal(got_hm, hm)

    def test_ingest_then_halo_kernels(self, mesh, rng):
        # end-to-end: distributed ingest -> device halo build -> halo SpMV
        csr = random_csr(rng, n=72, avg_deg=4)
        coo = csr.convert(COO)
        sh = ShardedCSR.from_coo_sharded(
            jnp.asarray(np.asarray(coo.row)), jnp.asarray(np.asarray(coo.col)),
            jnp.asarray(np.asarray(coo.vals)), csr.shape, mesh,
        ).with_halo()
        x = rng.standard_normal(csr.ncols).astype(np.float32)
        y = np.asarray(halo.spmv(sh, jnp.asarray(x), mesh))
        ref = np.asarray(csr.to_dense()) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)


class TestHaloSpmv:
    def test_matches_dense_path_and_host(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        x = rng.standard_normal(csr.ncols).astype(np.float32)
        y_halo = np.asarray(halo.spmv(sh, jnp.asarray(x), mesh))
        y_dense = np.asarray(dist.spmv(sh, jnp.asarray(x), mesh))
        ref = np.asarray(csr.to_dense()) @ x
        np.testing.assert_allclose(y_halo, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y_halo, y_dense, rtol=1e-5, atol=1e-5)

    def test_pattern_matrix(self, mesh):
        csr = path_csr(24)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        x = jnp.ones((24,), jnp.float32)
        y = np.asarray(halo.spmv(sh, x, mesh))
        # path graph row sums: 1 at ends, 2 inside
        want = np.full(24, 2.0, np.float32)
        want[0] = want[-1] = 1.0
        np.testing.assert_allclose(y, want)

    def test_requires_halo(self, mesh, rng):
        csr = random_csr(rng)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        with pytest.raises(ValueError, match="halo"):
            halo.spmv(sh, jnp.ones((csr.ncols,), jnp.float32), mesh)


class TestHaloBfs:
    def test_path_levels(self, mesh):
        n = 16
        sh = ShardedCSR.from_csr(path_csr(n), mesh, halo=True)
        levels = np.asarray(halo.bfs_levels(sh, 0, mesh))
        np.testing.assert_array_equal(levels, np.arange(n))

    def test_matches_dense_bfs(self, mesh, rng):
        csr = random_csr(rng, n=80, avg_deg=3)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        lev_halo = np.asarray(halo.bfs_levels(sh, 0, mesh))
        lev_dense = np.asarray(dist.bfs_levels(sh, 0, mesh))
        np.testing.assert_array_equal(lev_halo, lev_dense)

    def test_disconnected(self, mesh):
        n = 8
        csr = coo_to_csr(
            COO.new(
                np.array([0, 1], np.int32), np.array([1, 0], np.int32), None, shape=(n, n)
            )
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        levels = np.asarray(halo.bfs_levels(sh, 0, mesh))
        assert levels[0] == 0 and levels[1] == 1
        assert (levels[2:] == -1).all()


class TestHaloLabelProp:
    def test_valid_partition(self, mesh, rng):
        csr = random_csr(rng, n=64, avg_deg=6)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        labels = np.asarray(halo.label_prop_partition(sh, 4, mesh, num_iters=8))
        fx.check_partition(labels, 64, 4)

    def test_locality_on_blocks(self, mesh, rng):
        # two cliques joined by one edge: 2-way label prop should cut ~1 edge
        n = 32
        half = n // 2
        rows, cols = [], []
        for blk in (0, half):
            for i in range(half):
                for j in range(half):
                    if i != j:
                        rows.append(blk + i)
                        cols.append(blk + j)
        rows += [half - 1, half]
        cols += [half, half - 1]
        csr = coo_to_csr(
            COO.new(np.array(rows, np.int32), np.array(cols, np.int32), None, shape=(n, n))
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        labels = np.asarray(halo.label_prop_partition(sh, 2, mesh, num_iters=10))
        cut = int(dist.edge_cut(sh, jnp.asarray(labels), mesh))
        assert cut <= 4  # the single bridge (2 directed entries) + slack


class TestHaloRcm:
    def test_path_bandwidth_one(self, mesh):
        n = 32
        csr = path_csr(n)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        order = np.asarray(halo.rcm_reorder(sh, mesh, root=0))
        fx.check_reorder(order, n)
        row = np.concatenate([np.arange(n - 1), np.arange(1, n)])
        col = np.concatenate([np.arange(1, n), np.arange(n - 1)])
        assert np.abs(order[row] - order[col]).max() == 1

    def test_valid_on_random(self, mesh, rng):
        csr = random_csr(rng, n=48, avg_deg=2, with_vals=False)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        order = np.asarray(halo.rcm_reorder(sh, mesh, root=0))
        fx.check_reorder(order, 48)

    def test_reduces_bandwidth(self, mesh, rng):
        # banded matrix scrambled by a random permutation: RCM must undo
        # most of the damage
        n = 96
        rng2 = np.random.default_rng(7)
        perm = rng2.permutation(n)
        rows, cols = [], []
        for i in range(n):
            for j in range(max(0, i - 2), min(n, i + 3)):
                if i != j:
                    rows.append(perm[i])
                    cols.append(perm[j])
        csr = coo_to_csr(
            COO.new(np.array(rows, np.int32), np.array(cols, np.int32), None, shape=(n, n))
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        order = np.asarray(halo.rcm_reorder(sh, mesh))
        fx.check_reorder(order, n)
        r, c = np.array(rows), np.array(cols)
        bw0 = np.abs(r - c).max()
        bw1 = np.abs(order[r] - order[c]).max()
        assert bw1 < bw0
        assert bw1 <= 8  # near-banded again (true band = 2)


class TestCommVolume:
    def test_boundary_proportional(self, mesh):
        # path graph over 8 shards: boundary = 2 vertices per internal cut
        n = 512
        sh = ShardedCSR.from_csr(path_csr(n), mesh, halo=True)
        per_step = halo.step_comm_bytes(sh)
        # 7 internal boundaries × 2 directed halo vertices × 4 B = 56 B
        assert per_step <= 16 * 4 * 8
        # dense psum path moves the full (n,) per shard per step
        assert per_step < n * 4

    def test_hlo_uses_all_to_all(self, mesh):
        sh = ShardedCSR.from_csr(path_csr(64), mesh, halo=True)
        x = jnp.ones((64,), jnp.float32)
        hlo = (
            jax.jit(lambda s, v: halo.spmv(s, v, mesh))
            .lower(sh, x)
            .compile()
            .as_text()
        )
        assert "all-to-all" in hlo

    def test_halo_counts_match_boundary(self, mesh):
        n = 512
        sh = ShardedCSR.from_csr(path_csr(n), mesh, halo=True)
        counts = np.asarray(jax.device_get(sh.halo_counts))
        # each shard reads exactly 1 vertex from each neighbor shard
        rows = sh.rows_per_shard
        d = sh.n_shards
        for o in range(d):
            for r in range(d):
                expect = 1 if abs(o - r) == 1 else 0
                assert counts[o, r] == expect, (o, r, counts[o, r])


class TestSharded2D:
    def test_spmv_matches_host(self, mesh2d, rng):
        from sparsebase_tpu.parallel import sharded2d

        csr = random_csr(rng, n=72, avg_deg=5)
        sh = sharded2d.Sharded2DCSR.from_csr(csr, mesh2d)
        assert sh.nnz == csr.nnz
        x = rng.standard_normal(csr.ncols).astype(np.float32)
        y = np.asarray(sharded2d.spmv(sh, jnp.asarray(x), mesh2d))
        ref = np.asarray(csr.to_dense()) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)

    def test_degrees(self, mesh2d, rng):
        from sparsebase_tpu.parallel import sharded2d

        csr = random_csr(rng, n=56, avg_deg=4)
        sh = sharded2d.Sharded2DCSR.from_csr(csr, mesh2d)
        d = np.asarray(sharded2d.degrees(sh, mesh2d))
        np.testing.assert_array_equal(d, np.diff(np.asarray(csr.indptr)))

    def test_hlo_uses_reduce_scatter(self, mesh2d, rng):
        from sparsebase_tpu.parallel import sharded2d

        csr = random_csr(rng, n=64, avg_deg=4)
        sh = sharded2d.Sharded2DCSR.from_csr(csr, mesh2d)
        x = jnp.ones((csr.ncols,), jnp.float32)
        hlo = (
            jax.jit(lambda s, v: sharded2d.spmv(s, v, mesh2d))
            .lower(sh, x)
            .compile()
            .as_text()
        )
        assert "reduce-scatter" in hlo

    def test_pattern_matrix(self, mesh2d):
        from sparsebase_tpu.parallel import sharded2d

        csr = path_csr(40)
        sh = sharded2d.Sharded2DCSR.from_csr(csr, mesh2d)
        y = np.asarray(sharded2d.spmv(sh, jnp.ones((40,), jnp.float32), mesh2d))
        want = np.full(40, 2.0, np.float32)
        want[0] = want[-1] = 1.0
        np.testing.assert_allclose(y, want)


class TestMeshConversionEdges:
    """ShardedCSR as a first-class node in the conversion graph: the
    mesh-placement edge analogue of the reference's context-conditional
    CUDA edges (converter_order_two.cc:288-341)."""

    def test_csr_to_sharded_via_convert(self, mesh, rng):
        from sparsebase_tpu.context import MeshContext

        csr = random_csr(rng)
        ctx = MeshContext(mesh, "x")
        sh = csr.convert(ShardedCSR, ctx)
        assert isinstance(sh, ShardedCSR)
        assert sh.nnz == csr.nnz
        back = sh.convert(type(csr))
        np.testing.assert_array_equal(np.asarray(back.indptr), np.asarray(csr.indptr))
        np.testing.assert_array_equal(np.asarray(back.indices), np.asarray(csr.indices))

    def test_coo_to_sharded_multihop(self, mesh, rng):
        # COO -> CSR -> ShardedCSR: BFS finds the 2-hop chain when the
        # target context is a mesh
        from sparsebase_tpu.context import MeshContext

        csr = random_csr(rng)
        coo = csr.convert(COO)
        sh = coo.convert(ShardedCSR, MeshContext(mesh, "x"))
        assert isinstance(sh, ShardedCSR)
        assert sh.nnz == csr.nnz

    def test_unreachable_without_mesh_context(self, rng):
        from sparsebase_tpu.utils.exceptions import ConversionError

        csr = random_csr(rng)
        with pytest.raises(ConversionError):
            csr.convert(ShardedCSR)  # no mesh context -> edge gated off


class TestHaloRefine:
    def test_edge_cut_matches_dense(self, mesh, rng):
        csr = random_csr(rng, n=64, avg_deg=5)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        labels = jnp.asarray(rng.integers(0, 3, 64).astype(np.int32))
        got = int(np.asarray(halo.edge_cut(sh, labels, mesh)))
        want = int(np.asarray(dist.edge_cut(sh, labels, mesh)))
        assert got == want

    def test_refine_reduces_cut(self, mesh, rng):
        csr = random_csr(rng, n=96, avg_deg=6)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        k = 4
        labels0 = jnp.asarray((np.arange(96) * k // 96).astype(np.int32))
        scr = rng.integers(0, 96, 32)
        labels0 = labels0.at[scr].set(jnp.asarray(rng.integers(0, k, 32), jnp.int32))
        cut0 = int(np.asarray(halo.edge_cut(sh, labels0, mesh)))
        labels1 = halo.refine_partition(sh, labels0, k, mesh, rounds=4)
        cut1 = int(np.asarray(halo.edge_cut(sh, jnp.asarray(labels1), mesh)))
        assert cut1 <= cut0, (cut0, cut1)
        labels1 = np.asarray(labels1)
        assert labels1.min() >= 0 and labels1.max() < k
        sizes = np.bincount(labels1, minlength=k)
        assert sizes.max() <= 1.3 * 96 / k

    def test_refine_respects_headroom(self, mesh, rng):
        # one part at capacity: admission must not push it further over
        n, k = 64, 2
        csr = random_csr(rng, n=n, avg_deg=4)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        labels0 = jnp.asarray((np.arange(n) >= n // 4).astype(np.int32))  # part1 = 75%
        labels1 = np.asarray(halo.refine_partition(sh, labels0, k, mesh, rounds=3))
        sizes = np.bincount(labels1, minlength=k)
        cap = 1.1 * n / k
        before = np.bincount(np.asarray(labels0), minlength=k)
        # the oversized part must not grow
        assert sizes[1] <= before[1]


class TestHeavyEdgeMatching:
    def test_valid_matching_random(self, mesh, rng):
        # symmetric weighted graph
        n = 64
        r0 = rng.integers(0, n, 200).astype(np.int32)
        c0 = rng.integers(0, n, 200).astype(np.int32)
        keep = r0 != c0
        r0, c0 = r0[keep], c0[keep]
        r = np.concatenate([r0, c0])
        c = np.concatenate([c0, r0])
        w = rng.random(len(r0)).astype(np.float32)
        v = np.concatenate([w, w])
        keys = r.astype(np.int64) * n + c
        uniq, idx = np.unique(keys, return_index=True)
        r, c, v = r[idx], c[idx], v[idx]
        csr = coo_to_csr(COO.new(r, c, v, shape=(n, n)))
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        match = np.asarray(halo.heavy_edge_matching(sh, mesh, rounds=6))
        # involution: match[match[v]] == v
        assert (match[match] == np.arange(n)).all()
        # matched pairs are actual edges
        A = np.zeros((n, n), bool)
        A[r, c] = True
        for vtx in range(n):
            if match[vtx] != vtx:
                assert A[vtx, match[vtx]], (vtx, match[vtx])

    def test_path_matches_most(self, mesh):
        n = 32
        sh = ShardedCSR.from_csr(path_csr(n), mesh, halo=True)
        match = np.asarray(halo.heavy_edge_matching(sh, mesh, rounds=8))
        assert (match[match] == np.arange(n)).all()
        matched = (match != np.arange(n)).sum()
        # a path admits a perfect matching; handshake rounds should pair
        # most vertices (maximal matching >= n/2 of max)
        assert matched >= n // 2

    def test_weight_quality_vs_greedy(self, mesh, rng):
        # handshake matching >= 1/2 the weight of host greedy matching
        n = 48
        r0 = rng.integers(0, n, 150).astype(np.int32)
        c0 = rng.integers(0, n, 150).astype(np.int32)
        keep = r0 != c0
        r0, c0 = r0[keep], c0[keep]
        w0 = rng.random(len(r0)).astype(np.float32)
        r = np.concatenate([r0, c0]); c = np.concatenate([c0, r0])
        v = np.concatenate([w0, w0])
        keys = r.astype(np.int64) * n + c
        uniq, idx = np.unique(keys, return_index=True)
        r, c, v = r[idx], c[idx], v[idx]
        csr = coo_to_csr(COO.new(r, c, v, shape=(n, n)))
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        match = np.asarray(halo.heavy_edge_matching(sh, mesh, rounds=8))
        got = sum(
            float(v[(r == a) & (c == match[a])][0])
            for a in range(n) if match[a] > a
        )
        # host greedy: sort edges by weight desc, take if both free
        order = np.argsort(-v)
        used = np.zeros(n, bool)
        greedy = 0.0
        for k in order:
            a, b = int(r[k]), int(c[k])
            if not used[a] and not used[b] and a != b:
                used[a] = used[b] = True
                greedy += float(v[k])
        assert got >= 0.5 * greedy, (got, greedy)


class TestCoarsen:
    def _host_coarse(self, r, c, v, match, n):
        # host model: rep = lower endpoint; coarse ids by rep rank
        rep = np.arange(n) <= match
        cid = np.cumsum(rep) - 1
        cid = np.where(rep, cid, cid[match])
        cu, cv = cid[r], cid[c]
        keep = cu != cv
        edges = {}
        for a, b, w in zip(cu[keep], cv[keep], v[keep]):
            edges[(int(a), int(b))] = edges.get((int(a), int(b)), 0.0) + float(w)
        return int(rep.sum()), edges

    def test_path_contraction(self, mesh):
        n = 32
        csr = path_csr(n)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        match = np.asarray(halo.heavy_edge_matching(sh, mesh, rounds=8))
        coarse = halo.coarsen(sh, match, mesh)
        r = np.repeat(np.arange(n), np.diff(np.asarray(csr.indptr)))
        c = np.asarray(csr.indices)
        v = np.ones(len(r), np.float32)
        nc, want_edges = self._host_coarse(r, c, v, match, n)
        assert coarse.shape == (nc, nc)
        back = coarse.to_csr()
        rr = np.repeat(np.arange(nc), np.diff(np.asarray(back.indptr)))
        cc = np.asarray(back.indices)
        ww = np.asarray(back.vals)
        got_edges = {}
        for a, b, w in zip(rr, cc, ww):
            got_edges[(int(a), int(b))] = got_edges.get((int(a), int(b)), 0.0) + float(w)
        assert got_edges.keys() == want_edges.keys()
        for k in want_edges:
            np.testing.assert_allclose(got_edges[k], want_edges[k], rtol=1e-6)

    def test_weighted_random_contraction(self, mesh, rng):
        n = 48
        r0 = rng.integers(0, n, 150).astype(np.int32)
        c0 = rng.integers(0, n, 150).astype(np.int32)
        keep = r0 != c0
        r0, c0 = r0[keep], c0[keep]
        w0 = rng.random(len(r0)).astype(np.float32)
        r = np.concatenate([r0, c0]); c = np.concatenate([c0, r0])
        v = np.concatenate([w0, w0])
        keys = r.astype(np.int64) * n + c
        uniq, idx = np.unique(keys, return_index=True)
        r, c, v = r[idx], c[idx], v[idx]
        csr = coo_to_csr(COO.new(r, c, v, shape=(n, n)))
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        match = np.asarray(halo.heavy_edge_matching(sh, mesh, rounds=8))
        coarse = halo.coarsen(sh, match, mesh)
        nc, want_edges = self._host_coarse(
            np.repeat(np.arange(n), np.diff(np.asarray(csr.indptr))),
            np.asarray(csr.indices), np.asarray(csr.vals), match, n
        )
        assert coarse.shape == (nc, nc)
        # weight conservation: coarse total = original total - intra-pair
        total_want = sum(want_edges.values())
        back = coarse.to_csr()
        np.testing.assert_allclose(
            float(np.asarray(back.vals).sum()), total_want, rtol=1e-5
        )
        # two-level: matching + coarsen again composes
        match2 = np.asarray(halo.heavy_edge_matching(coarse, mesh, rounds=6))
        coarse2 = halo.coarsen(coarse, match2, mesh)
        assert coarse2.shape[0] <= coarse.shape[0]


class TestMultilevelPartition:
    def test_beats_flat_labelprop(self, mesh, rng):
        # locality-rich graph: 2-D grid; multilevel should cut no worse
        # than flat LP+refine
        side = 14
        n = side * side
        rows, cols = [], []
        for i in range(side):
            for j in range(side):
                v = i * side + j
                for di, dj in ((0, 1), (1, 0)):
                    ii, jj = i + di, j + dj
                    if ii < side and jj < side:
                        u = ii * side + jj
                        rows += [v, u]
                        cols += [u, v]
        csr = coo_to_csr(
            COO.new(np.array(rows, np.int32), np.array(cols, np.int32), None,
                    shape=(n, n))
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        k = 4
        ml = halo.multilevel_partition(sh, k, mesh, coarsen_until=32)
        fx.check_partition(np.asarray(ml), n, k)
        cut_ml = int(np.asarray(halo.edge_cut(sh, jnp.asarray(ml), mesh)))
        flat = halo.label_prop_partition(sh, k, mesh, num_iters=20)
        flat = halo.refine_partition(sh, flat, k, mesh, rounds=6)
        cut_flat = int(np.asarray(halo.edge_cut(sh, jnp.asarray(flat), mesh)))
        assert cut_ml <= cut_flat * 1.2, (cut_ml, cut_flat)
        sizes = np.bincount(np.asarray(ml), minlength=k)
        assert sizes.max() <= 1.35 * n / k

    def test_valid_on_random(self, mesh, rng):
        csr = random_csr(rng, n=120, avg_deg=5)
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        labels = halo.multilevel_partition(sh, 3, mesh, coarsen_until=24)
        fx.check_partition(np.asarray(labels), 120, 3)
