"""DIA format + banded SpMV tests."""

import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import COO, CSR
from sparsebase_tpu.convert import convert
from sparsebase_tpu.convert.kernels import csr_to_dia, dia_to_csr
from sparsebase_tpu.formats.dia import DIA
from sparsebase_tpu.ops.kernels import (
    banded_spmv,
    dia_spmv_reference,
)


def tridiag(n, dtype=np.float32):
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in (i - 1, i, i + 1):
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
                vals.append(float(i + j + 1))
    return COO.new(
        np.array(rows, np.int32),
        np.array(cols, np.int32),
        np.array(vals, dtype),
        shape=(n, n),
    ).convert(CSR)


class TestDIAFormat:
    def test_fixture_roundtrip(self):
        csr = fx.make_csr()
        dia = csr_to_dia(csr)
        np.testing.assert_array_equal(dia.to_dense(), fx.DENSE)
        back = dia_to_csr(dia)
        fx.compare_csr(csr, back)

    def test_offsets_sorted(self):
        dia = csr_to_dia(tridiag(10))
        np.testing.assert_array_equal(np.asarray(dia.offsets), [-1, 0, 1])
        assert dia.bandwidth == 1
        assert dia.num_diagonals == 3

    def test_conversion_graph_edge(self):
        dia = convert(fx.make_csr(), DIA)
        assert isinstance(dia, DIA)
        back = convert(dia, CSR)
        fx.compare_csr(fx.make_csr(), back)

    def test_coo_to_dia_multihop(self):
        dia = convert(fx.make_coo(), DIA)  # COO -> CSR -> DIA via BFS
        np.testing.assert_array_equal(dia.to_dense(), fx.DENSE)

    def test_device_conversion(self):
        csr = tridiag(32).to_device()
        dia = csr_to_dia(csr)
        np.testing.assert_allclose(np.asarray(dia.to_dense()), np.asarray(tridiag(32).to_dense()))

    def test_device_conversion_graph_edge(self):
        # the conversion graph runs CSR -> DIA on a device input too
        dia = tridiag(32).to_device().convert(DIA)
        assert not isinstance(dia.data, np.ndarray)
        np.testing.assert_allclose(np.asarray(dia.to_dense()), np.asarray(tridiag(32).to_dense()))

    def test_rectangular(self):
        csr = fx.make_csr()  # square fixture; now a wide one
        import dataclasses

        wide = CSR.new(
            np.array([0, 2, 3], np.int32),
            np.array([0, 4, 2], np.int32),
            np.array([1.0, 2.0, 3.0], np.float32),
            shape=(2, 5),
        )
        dia = csr_to_dia(wide)
        np.testing.assert_allclose(dia.to_dense(), wide.to_dense())


class TestBandedSpMV:
    def test_matches_dense_tridiag(self, rng):
        csr = tridiag(100)
        dia = csr_to_dia(csr)
        x = rng.standard_normal(100).astype(np.float32)
        y = np.asarray(banded_spmv(dia, x))
        ref = np.asarray(csr.to_dense()).astype(np.float64) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-4)

    def test_matches_reference_impl(self, rng):
        csr = tridiag(257)  # non-multiple of BLOCK
        dia = csr_to_dia(csr)
        x = rng.standard_normal(257).astype(np.float32)
        y = np.asarray(banded_spmv(dia, x))
        ref = np.asarray(dia_spmv_reference(dia, x))
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize(
        "case", ["tridiag-100", "tridiag-257", "tridiag-1024", "bf16-band", "wide-band"]
    )
    def test_banded_kernel_matches(self, rng, case):
        # the DIA SpMV against the plain reference
        import jax.numpy as jnp

        if case.startswith("tridiag"):
            n = int(case.split("-")[1])
            dia = csr_to_dia(tridiag(n))
            ref_dia, rtol, atol = dia, 1e-4, 1e-3
        elif case == "bf16-band":
            # bf16 band values, f32 accumulate
            n = 513
            ref_dia = csr_to_dia(tridiag(n))
            dia = ref_dia.astype(jnp.bfloat16)
            rtol, atol = 2e-2, None
        else:
            n = 640
            dense = np.zeros((n, n), np.float32)
            for off in (-150, -7, 0, 2, 133):
                i = np.arange(n)
                j = i + off
                ok = (j >= 0) & (j < n)
                dense[i[ok], j[ok]] = rng.standard_normal(int(ok.sum())).astype(np.float32)
            r, c = np.nonzero(dense)
            ref_dia = dia = csr_to_dia(
                COO.new(r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(n, n)).convert(CSR)
            )
            rtol, atol = 1e-4, 1e-4
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(banded_spmv(dia, x))
        ref = np.asarray(dia_spmv_reference(ref_dia, x))
        if atol is None:
            # bf16 mantissa is 8 bits: error scales with the result magnitude
            atol = 2e-2 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(y, ref, rtol=rtol, atol=atol)

    def test_wide_band_random(self, rng):
        n = 200
        dense = np.zeros((n, n), np.float32)
        for off in (-7, -3, 0, 2, 9):
            i = np.arange(n)
            j = i + off
            ok = (j >= 0) & (j < n)
            dense[i[ok], j[ok]] = rng.standard_normal(ok.sum()).astype(np.float32)
        r, c = np.nonzero(dense)
        csr = COO.new(
            r.astype(np.int32), c.astype(np.int32), dense[r, c], shape=(n, n)
        ).convert(CSR)
        dia = csr_to_dia(csr)
        x = rng.standard_normal(n).astype(np.float32)
        y = np.asarray(banded_spmv(dia, x))
        np.testing.assert_allclose(y, dense.astype(np.float64) @ x, rtol=1e-4, atol=1e-4)

    def test_rcm_then_banded_pipeline(self):
        # the showcase flow: reorder -> band -> banded SpMV
        from sparsebase_tpu.bases import ReorderBase
        from sparsebase_tpu.ops.reorder import RCMReorder

        csr = tridiag(64)
        # scramble it first
        rng = np.random.default_rng(1)
        perm = rng.permutation(64).astype(np.int32)
        scrambled = ReorderBase.permute2d(perm, csr)
        order = RCMReorder().get_reorder(scrambled)
        banded = ReorderBase.permute2d(order, scrambled)
        dia = csr_to_dia(banded)
        assert dia.bandwidth <= 4  # RCM should recover a narrow band
        x = np.ones(64, np.float32)
        y = np.asarray(banded_spmv(dia, x))
        ref = np.asarray(banded.to_dense()).astype(np.float64) @ x
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-4)
