"""Shared helpers for the example scripts."""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

# the reference's ash958, symmetrized, as committed with the parity goldens
ASH958 = str(Path(__file__).parent.parent / "tests" / "golden" / "ash958_sym.mtx")


def parse_args(description):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("matrix", nargs="?", default=ASH958, help="path to a .mtx file")
    p.add_argument("--device", action="store_true", help="run compute on the GPU")
    args = p.parse_args()
    if not args.device:
        # without --device the example stays on the CPU even where a GPU
        # is present
        import jax

        jax.config.update("jax_platforms", "cpu")
    return args


def load_symmetric_graph(path, device=False):
    """Read an MTX file and symmetrize it into a square pattern graph."""
    import numpy as np

    import sparsebase_tpu as sb
    from sparsebase_tpu.bases import IOBase

    csr = IOBase.read_mtx_to_csr(path)
    n = max(csr.shape)
    coo = csr.convert(sb.COO)
    row = np.concatenate([np.asarray(coo.row), np.asarray(coo.col)]).astype(np.int64)
    col = np.concatenate([np.asarray(coo.col), np.asarray(coo.row)]).astype(np.int64)
    # deduplicate (a symmetric input would otherwise list every edge twice)
    keys = np.unique(row * n + col)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    g = sb.COO.new(row, col, None, shape=(n, n)).convert(sb.CSR)
    return g.to_device() if device else g
