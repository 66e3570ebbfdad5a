"""The reorder→format payoff pipeline (tutorial 007; the answer to the
reference's CUDA SpMV tutorial, docs/pages/tutorials/004_cuda_spmv.md):
scramble a banded matrix, recover the band with RCM, convert to DIA —
the format the reordering made legal — and check the gather-free SpMV
against the flat-CSR result. This example verifies the pipeline's
semantics at demo scale on any backend; ``chip_smoke.py`` phase B runs
the same path at HPCG's size on the GPU."""

import numpy as np
from _common import parse_args

from sparsebase_tpu import COO, CSR, DIA
from sparsebase_tpu.bases import ReorderBase
from sparsebase_tpu.models.pipelines import spmv
from sparsebase_tpu.ops.feature import Bandwidth
from sparsebase_tpu.ops.reorder import RCMReorder


def main():
    parse_args(__doc__)
    rng = np.random.default_rng(0)
    n, half_bw = 4000, 4

    # banded matrix, then a random symmetric scramble
    row = np.repeat(np.arange(n), 2 * half_bw)
    col = np.clip(row + np.tile(np.r_[-half_bw:0, 1 : half_bw + 1], n), 0, n - 1)
    keys = np.unique(row * n + col)
    keys = np.union1d(keys, (keys % n) * n + keys // n)  # symmetrize
    row, col = (keys // n).astype(np.int64), (keys % n).astype(np.int64)
    vals = rng.standard_normal(len(row)).astype(np.float32)
    scram = rng.permutation(n).astype(np.int64)
    coo = COO.new(scram[row], scram[col], vals, shape=(n, n))
    csr = coo.convert(CSR)
    bw0 = Bandwidth().get_bandwidth(csr)

    # RCM recovers the band -> DIA becomes admissible
    order = ReorderBase.reorder(RCMReorder, csr)
    banded = ReorderBase.permute2d(order, csr)
    bw1 = Bandwidth().get_bandwidth(banded)
    dia = banded.convert(DIA)
    print(f"bandwidth {bw0} -> {bw1}; DIA diagonals = {dia.num_diagonals}")

    x = rng.standard_normal(n).astype(np.float32)
    y_flat = np.asarray(spmv(banded, x))
    y_dia = np.asarray(spmv(dia, x))  # gather-free banded kernel
    assert np.allclose(y_flat, y_dia, atol=1e-3)
    print("flat-CSR and DIA SpMV agree")


if __name__ == "__main__":
    main()
