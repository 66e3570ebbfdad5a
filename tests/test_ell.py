"""ELL (row-padded) format: conversions, SpMV, and the row-gather
permutation (the relocation path for pipelines that stay padded)."""

import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO, CSR, ELL
from sparsebase_tpu.bases import ReorderBase
from sparsebase_tpu.models.pipelines import spmv_ell


def random_csr(rng, n=40, avg_deg=5, with_vals=True):
    nnz = n * avg_deg
    r = rng.integers(0, n, nnz).astype(np.int64)
    c = rng.integers(0, n, nnz).astype(np.int64)
    keys = np.unique(r * n + c)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    vals = rng.standard_normal(len(row)).astype(np.float32) if with_vals else None
    return COO.new(row, col, vals, shape=(n, n)).convert(CSR)


class TestEllConversion:
    def test_round_trip_fixture(self):
        csr = fx.make_csr()
        ell = csr.convert(ELL)
        back = ell.convert(CSR)
        np.testing.assert_array_equal(np.asarray(back.to_dense()),
                                      np.asarray(csr.to_dense()))

    @pytest.mark.parametrize("seed,with_vals", [(0, True), (1, False), (2, True)])
    def test_round_trip_random(self, seed, with_vals):
        rng = np.random.default_rng(seed)
        csr = random_csr(rng, with_vals=with_vals)
        ell = csr.convert(ELL)
        assert ell.nnz == csr.nnz
        assert ell.width == int(np.diff(np.asarray(csr.indptr)).max())
        back = ell.convert(CSR)
        np.testing.assert_array_equal(np.asarray(back.indptr),
                                      np.asarray(csr.indptr))
        np.testing.assert_array_equal(np.asarray(back.indices),
                                      np.asarray(csr.indices))
        if with_vals:
            np.testing.assert_allclose(np.asarray(back.vals),
                                       np.asarray(csr.vals))

    def test_device_round_trip(self, rng):
        csr = random_csr(rng, n=32).to_device()
        ell = csr.convert(ELL)
        back = ell.convert(CSR)
        np.testing.assert_allclose(np.asarray(back.to_dense()),
                                   np.asarray(csr.to_dense()), rtol=1e-6)

    def test_explicit_width_raises_when_too_small(self):
        csr = fx.make_csr()
        from sparsebase_tpu.convert.kernels import csr_to_ell

        with pytest.raises(ValueError):
            csr_to_ell(csr, width=0 if csr.nnz else 1)


class TestEllSpmv:
    def test_matches_dense(self, rng):
        csr = random_csr(rng, n=50)
        ell = csr.convert(ELL)
        x = rng.standard_normal(50).astype(np.float32)
        y = np.asarray(spmv_ell(ell, x))
        ref = np.asarray(csr.to_dense()) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-5)

    def test_pattern(self, rng):
        csr = random_csr(rng, n=30, with_vals=False)
        ell = csr.convert(ELL)
        x = rng.standard_normal(30).astype(np.float32)
        ref = (np.asarray(csr.to_dense()) != 0).astype(np.float32) @ x
        np.testing.assert_allclose(np.asarray(spmv_ell(ell, x)), ref,
                                   rtol=1e-4, atol=1e-5)


class TestEllPermute:
    def test_permute2d_matches_csr_path(self, rng):
        csr = random_csr(rng, n=36)
        order = np.asarray(
            ReorderBase.reorder("degree", csr)
        ).astype(np.int32)
        want = ReorderBase.permute2d(order, csr)
        ell = csr.convert(ELL)
        got = ReorderBase.permute2d(order, ell).convert(CSR)
        np.testing.assert_array_equal(np.asarray(got.indptr),
                                      np.asarray(want.indptr))
        np.testing.assert_array_equal(np.asarray(got.indices),
                                      np.asarray(want.indices))
        np.testing.assert_allclose(np.asarray(got.vals), np.asarray(want.vals))

    def test_rows_only_device(self, rng):
        csr = random_csr(rng, n=24).to_device()
        n = 24
        order = np.random.default_rng(5).permutation(n).astype(np.int32)
        want = ReorderBase.permute2d_rowwise(order, csr)
        ell = csr.convert(ELL)
        got = ReorderBase.permute2d_rowwise(order, ell).convert(CSR)
        np.testing.assert_allclose(np.asarray(got.to_dense()),
                                   np.asarray(want.to_dense()), rtol=1e-6)

    def test_auto_convert_dispatch(self, rng):
        # feeding a CSR to an op registered on ELL must auto-convert
        from sparsebase_tpu.ops.permute import PermuteOrderTwo

        csr = random_csr(rng, n=20)
        order = np.arange(20)[::-1].astype(np.int32).copy()
        out = PermuteOrderTwo(order, order).get_permutation(csr.convert(ELL))
        assert isinstance(out, ELL)
