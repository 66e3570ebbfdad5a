"""Ring-collective (ppermute) matmul kernel tests: distributed triangle
counting and Jaccard weights vs the host implementations.

The reference computes Jaccard on one GPU (jaccard_weights_cuda.cu) and
triangles sequentially (triangle_count.cc:141-205); the ring kernels are
mesh-distributed work, verified here for exact agreement with
the host paths on the virtual 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparsebase_tpu.formats.csr import CSR
from sparsebase_tpu.ops.feature.jaccard import _jaccard_host
from sparsebase_tpu.ops.feature.triangles import _directed_count, _undirected_count
from sparsebase_tpu.parallel import ShardedCSR, make_mesh, ring


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def random_csr(rng, n=60, avg_deg=5, symmetric=False):
    nnz = n * avg_deg
    row = rng.integers(0, n, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    keep = row != col  # simple graph: no self-loops
    row, col = row[keep], col[keep]
    if symmetric:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
    keys = np.unique(row * n + col)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    counts = np.bincount(row, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSR(indptr, col, None, (n, n))


class TestRingTriangles:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_undirected_matches_host(self, mesh, seed):
        rng = np.random.default_rng(seed)
        csr = random_csr(rng, n=60 + 7 * seed, symmetric=True)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        got = ring.triangle_count(sh, mesh, directed=False)
        assert got == _undirected_count(csr)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_directed_matches_host(self, mesh, seed):
        rng = np.random.default_rng(100 + seed)
        csr = random_csr(rng, n=50 + 3 * seed, symmetric=False)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        got = ring.triangle_count(sh, mesh, directed=True)
        assert got == _directed_count(csr)

    def test_exact_past_f32_range(self, mesh):
        # K_512: 6T = 133,432,320 > 2**24 — exactness must survive the
        # psum'd global reduction (ADVICE r2 high: ring.py counterpart).
        n = 512
        dense = 1 - np.eye(n, dtype=np.int32)
        r, c = np.nonzero(dense)
        counts = np.bincount(r, minlength=n)
        csr = CSR(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            c.astype(np.int32), None, (n, n),
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        expect = n * (n - 1) * (n - 2) // 6
        assert ring.triangle_count(sh, mesh, directed=False) == expect

    def test_feature_parity_small_fixture(self, mesh):
        # 5-cycle plus one chord: exactly 1 triangle
        edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 2)]
        n = 5
        row = np.array([u for u, v in edges] + [v for u, v in edges], np.int64)
        col = np.array([v for u, v in edges] + [u for u, v in edges], np.int64)
        keys = np.unique(row * n + col)
        counts = np.bincount((keys // n).astype(np.int32), minlength=n)
        csr = CSR(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            (keys % n).astype(np.int32),
            None,
            (n, n),
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        assert ring.triangle_count(sh, mesh) == 1


class TestRingJaccard:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_host(self, mesh, seed):
        rng = np.random.default_rng(10 + seed)
        csr = random_csr(rng, n=64 + 5 * seed, symmetric=(seed % 2 == 0))
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        got = ring.jaccard_flat(sh, mesh)
        want = _jaccard_host(csr)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def test_padded_layout(self, mesh):
        rng = np.random.default_rng(7)
        csr = random_csr(rng, n=40)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        padded = np.asarray(jax.device_get(ring.jaccard_weights(sh, mesh)))
        assert padded.shape == sh.indices.shape
        counts = np.asarray(jax.device_get(sh.nnz_local))
        for i in range(padded.shape[0]):
            assert (padded[i, counts[i] :] == 0).all()


class TestSparseRing:
    """Sparse (binary-search) ring — the big-n path past MAX_DENSE_ELEMS
    (VERDICT r3 item 5). Parity vs both the dense ring and the host
    implementations."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_triangles_match_host_and_dense(self, mesh, seed):
        rng = np.random.default_rng(40 + seed)
        csr = random_csr(rng, n=70 + 9 * seed, avg_deg=6, symmetric=True)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        got = ring.triangle_count_sparse(sh, mesh)
        assert got == _undirected_count(csr)
        assert got == ring.triangle_count(sh, mesh, directed=False)

    def test_triangles_k512_exact_past_f32(self, mesh):
        n = 512
        dense = 1 - np.eye(n, dtype=np.int32)
        r, c = np.nonzero(dense)
        counts = np.bincount(r, minlength=n)
        csr = CSR(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            c.astype(np.int32), None, (n, n),
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        expect = n * (n - 1) * (n - 2) // 6
        assert ring.triangle_count_sparse(sh, mesh) == expect

    def test_triangles_tolerate_self_loops_and_duplicates(self, mesh):
        # triangle 0-1-2 plus a self-loop at 0 and a duplicated edge 0-1
        edges = [(0, 1), (1, 2), (2, 0), (0, 0), (0, 1)]
        n = 6
        row = np.array(
            [u for u, v in edges] + [v for u, v in edges], np.int64
        )
        col = np.array(
            [v for u, v in edges] + [u for u, v in edges], np.int64
        )
        order = np.lexsort((col, row))
        row, col = row[order], col[order]  # keep duplicates (multiset CSR)
        counts = np.bincount(row, minlength=n)
        csr = CSR(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            col.astype(np.int32), None, (n, n),
        )
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        assert ring.triangle_count_sparse(sh, mesh) == 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_jaccard_matches_host_and_dense(self, mesh, seed):
        rng = np.random.default_rng(50 + seed)
        csr = random_csr(rng, n=66 + 5 * seed, symmetric=(seed % 2 == 0))
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        got = np.asarray(jax.device_get(ring.jaccard_weights_sparse(sh, mesh)))
        dense = np.asarray(jax.device_get(ring.jaccard_weights(sh, mesh)))
        np.testing.assert_allclose(got, dense, rtol=0, atol=1e-6)
        counts = np.asarray(jax.device_get(sh.nnz_local))
        flat = np.concatenate([got[i, : counts[i]] for i in range(got.shape[0])])
        np.testing.assert_allclose(flat, _jaccard_host(csr), rtol=0, atol=1e-6)

    def test_auto_fallback_past_dense_guard(self, mesh, monkeypatch):
        # shrink the guard so the dense path refuses, and check the
        # public entry points route to the sparse ring transparently
        rng = np.random.default_rng(9)
        csr = random_csr(rng, n=64, symmetric=True)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        monkeypatch.setattr(ring, "MAX_DENSE_ELEMS", 1)
        assert ring.triangle_count(sh, mesh) == _undirected_count(csr)
        flat = ring.jaccard_flat(sh, mesh)
        np.testing.assert_allclose(flat, _jaccard_host(csr), rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="directed"):
            ring.triangle_count(sh, mesh, directed=True)


class TestRingHLO:
    def test_hlo_uses_ppermute_and_matmul(self, mesh):
        rng = np.random.default_rng(3)
        csr = random_csr(rng, n=48, symmetric=True)
        sh = ShardedCSR.from_csr(csr, mesh, halo=False)
        from sparsebase_tpu.parallel.ring import _triangle_runner

        axis, n, d, rows, width = (
            sh.axis,
            sh.shape[0],
            sh.n_shards,
            sh.rows_per_shard,
            sh.indices.shape[1],
        )
        f = _triangle_runner(mesh, axis, n, d, rows, width, False)
        hlo = f.lower(sh.indptr, sh.indices, sh.nnz_local).compile().as_text()
        assert "collective-permute" in hlo
        assert "dot(" in hlo or "dot general" in hlo or "dot-general" in hlo
