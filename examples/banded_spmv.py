"""RCM → DIA → banded SpMV: the reordering payoff
(reference: tutorials/004_cuda_spmv narrative, taken to its conclusion —
after bandwidth reduction the gather-free DIA kernel applies)."""

import numpy as np

from _common import load_symmetric_graph, parse_args

from sparsebase_tpu import DIA
from sparsebase_tpu.bases import ReorderBase
from sparsebase_tpu.models.pipelines import spmv
from sparsebase_tpu.ops.kernels import dia_spmv_reference
from sparsebase_tpu.ops.reorder import RCMReorder


def main():
    args = parse_args(__doc__)
    g = load_symmetric_graph(args.matrix, device=args.device)
    import dataclasses

    g = dataclasses.replace(g, vals=np.ones(g.nnz, np.float32))

    order = RCMReorder().get_reorder(g)
    banded = ReorderBase.permute2d(order, g)
    dia = banded.convert(DIA)
    print(f"after RCM: {dia}")

    x = np.ones(g.nrows, np.float32)
    y = np.asarray(spmv(dia, x))  # dispatches to the banded kernel
    y_ref = np.asarray(dia_spmv_reference(dia, x))
    print("banded kernel matches:", bool(np.allclose(y, y_ref, rtol=1e-4, atol=1e-3)))
    # degree check: SpMV of ones over a pattern matrix = row degrees
    deg = np.diff(np.asarray(banded.indptr))
    print("spmv(1) == degrees   :", bool(np.allclose(y_ref, deg)))


if __name__ == "__main__":
    main()
