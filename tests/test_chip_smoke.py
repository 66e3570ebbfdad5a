"""CPU tests for the GPU scripts: each ``chip_smoke.py`` phase at a tiny
size against its reference, the refusal to run without a GPU, the
compile-cache rule, and the native build stamp. The same phases at full
size run on the GPU (``python chip_smoke.py``)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def tiny_tiers(monkeypatch):
    """Tier limits scaled down so tiny graphs land on every tier."""
    import sparsebase_tpu.ops.feature.jaccard as jm
    import sparsebase_tpu.ops.feature.triangles as tm

    monkeypatch.setattr(tm, "MAX_DEVICE_DENSE_N", 4096)
    monkeypatch.setattr(jm, "MAX_FLAT_EXPANSION", 1 << 21)


class TestPhases:
    def test_pipeline(self):
        rec = cs.phase_pipeline(n=4096, nnz=65536, scipy_n=2048, scipy_nnz=32768)
        assert rec["structure"] == "exact"
        assert rec["y_max_err"] <= rec["y_atol"]
        assert rec["scipy_y_max_err"] <= rec["scipy_y_atol"]

    def test_stencil(self):
        rec, dia = cs.phase_stencil(g=8)
        assert rec["n"] == 512 and rec["nnz"] == (3 * 8 - 2) ** 3  # in-grid neighbour pairs
        assert rec["bandwidth_device_rcm"] <= 2 * rec["bandwidth_host_rcm"]
        assert rec["bandwidth_device_rcm"] < rec["bandwidth_scrambled"]
        assert dia.num_diagonals == 27

    def test_features(self, tiny_tiers):
        rec = cs.phase_features(dense_n=2048, dense_deg=8, sparse_n=20000, sparse_deg=16)
        for tier in ("dense", "sparse"):
            assert rec[tier]["jaccard_mismatches"] == 0
        assert rec["sparse"]["triangles"] > 0

    def test_dia(self):
        _, dia = cs.phase_stencil(g=6)
        rec = cs.phase_dia(dia, reps=1)
        for dt in ("float32", "bfloat16"):
            assert rec[dt]["err_over_bound"] <= 1.0
            assert len(rec[dt]["windows_s"]) == 4
        assert rec["float32"]["min_bytes"] == 27 * 216 * 4 + 2 * 216 * 4

    def test_ingest(self):
        rec = cs.phase_ingest(n=3000, avg_deg=8)
        assert rec["nnz"] > 20000

    def test_four_devices(self):
        import jax

        assert len(jax.devices()) >= 4
        recs = dict(cs.run_four_gpu(dict(n=4096, nnz=65536, feat_n=8000, feat_deg=8)))
        assert list(recs) == [
            "four/ingest", "four/halo_spmv", "four/dist_spmv", "four/label_prop",
            "four/halo_rcm", "four/spmv_2d", "four/ring_features",
        ]
        for step in ("four/halo_spmv", "four/dist_spmv", "four/spmv_2d"):
            assert recs[step]["err_over_bound"] <= 1.0
        assert recs["four/ring_features"]["jaccard_mismatches"] == 0
        assert sum(recs["four/label_prop"]["part_sizes"]) == 4096

    def test_phase_failure_raises(self):
        with pytest.raises(cs.SmokeFailure, match="boom"):
            cs.check(False, "boom")

    @pytest.mark.parametrize("nnz", [2, 1000, 100_000_000])
    def test_cumsum_atol(self, nnz):
        atol, c = cs.cumsum_atol(nnz, 10.0)
        assert c == 4 * int(np.ceil(np.log2(nnz))) + 1
        assert atol == pytest.approx(c * np.finfo(np.float32).eps * 10.0)


def _cpu_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


class TestNoGPU:
    @pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
    def test_refuses_without_gpu(self, script):
        r = subprocess.run(
            [sys.executable, str(REPO / script)],
            capture_output=True, text=True, timeout=120, env=_cpu_env(), cwd=str(REPO),
        )
        assert r.returncode != 0
        assert "no GPU" in r.stderr
        assert '"ok"' not in r.stdout

    def test_alone_without_repo(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"],
            capture_output=True, text=True, timeout=120, env=_cpu_env(), cwd=str(tmp_path),
        )
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_require_gpu_raises_on_cpu(self):
        from sparsebase_tpu.utils.device_run import NoGPUError, require_gpu

        with pytest.raises(NoGPUError):
            require_gpu()


class TestCompileCache:
    def test_env_set_is_left_to_jax(self, monkeypatch, tmp_path):
        import jax

        from sparsebase_tpu.utils import device_run

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert device_run.use_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_env_unset_uses_checkout_dir(self, monkeypatch):
        import jax

        from sparsebase_tpu.utils import device_run

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        try:
            path = device_run.use_compile_cache()
            assert path == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        assert ".jax_cache/" in (REPO / ".gitignore").read_text()


class TestNativeBuildStamp:
    SRC = 'extern "C" int sbtpu_probe() { return %d; }\n'

    def test_builds_once_and_rebuilds_on_change(self, tmp_path):
        import ctypes

        from sparsebase_tpu.utils import native_build as nb

        src, lib = tmp_path / "probe.cpp", tmp_path / "libprobe.so"
        src.write_text(self.SRC % 1)
        assert not nb.is_current(src, lib)
        nb.ensure_built(src, lib, timeout=120)
        assert nb.is_current(src, lib)
        assert nb.stamp_path(lib).read_text().strip() == nb.build_stamp(src)
        mtime = lib.stat().st_mtime_ns
        nb.ensure_built(src, lib, timeout=120)  # current: no rebuild
        assert lib.stat().st_mtime_ns == mtime
        # other flags -> another stamp -> rebuild
        flags = nb.FLAGS + ("-DSBTPU_PROBE=1",)
        assert nb.build_stamp(src, flags) != nb.build_stamp(src)
        assert not nb.is_current(src, lib, flags)
        # other source -> rebuild, and the new code is what loads
        src.write_text(self.SRC % 2)
        assert not nb.is_current(src, lib)
        nb.ensure_built(src, lib, timeout=120)
        assert ctypes.CDLL(str(lib)).sbtpu_probe() == 2

    def test_portable_flags(self):
        from sparsebase_tpu.utils import native_build as nb

        assert not [f for f in nb.FLAGS if f.startswith("-march")]

    def test_repo_libraries_are_stamped(self):
        from sparsebase_tpu import native
        from sparsebase_tpu.io import fastio
        from sparsebase_tpu.utils import native_build as nb

        assert fastio.available() and native.available()
        for mod in (fastio, native):
            assert nb.is_current(mod._SRC, mod._LIB_PATH)

    def test_failed_build_raises(self, tmp_path):
        from sparsebase_tpu.utils import native_build as nb

        src = tmp_path / "bad.cpp"
        src.write_text("this is not C++\n")
        with pytest.raises(subprocess.CalledProcessError):
            nb.ensure_built(src, tmp_path / "libbad.so", timeout=120)
        assert not (tmp_path / "libbad.so").exists()


@pytest.mark.gpu
class TestOnGPU:
    def test_banded_spmv_on_card(self, gpu):
        """The DIA SpMV compiled for the card, at a 2M-row width, against
        the plain reference."""
        import jax

        from sparsebase_tpu import DIA
        from sparsebase_tpu.ops.kernels import banded_spmv, dia_spmv_reference

        g = 128
        dia = cs._table_to_csr(*cs.stencil27(g), g**3).to_device().convert(DIA)
        x = jax.random.normal(jax.random.PRNGKey(0), (dia.shape[1],))
        np.testing.assert_allclose(
            np.asarray(banded_spmv(dia, x)),
            np.asarray(dia_spmv_reference(dia, x)),
            rtol=1e-5,
            atol=1e-4,
        )
