"""Distributed-RCM refinement sweep on the rand-20k expander (VERDICT r2
item 9): does more wave refinement / bigger bucket budgets close the +21%
bandwidth gap vs host RCM, or is it a formulation limit?

Runs on the virtual 8-device CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/rcm_refine_study.py

Prints a table; ash958 (structured) is included
as the control where distributed == host exactly.
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def bandwidth_of(csr, order):
    row = np.asarray(csr.row_of_nnz())
    col = np.asarray(csr.indices)
    o = np.asarray(order)
    return int(np.abs(o[row] - o[col]).max()) if len(row) else 0


def main():
    import jax.numpy as jnp

    from sparsebase_tpu import COO, CSR
    from sparsebase_tpu.bases import IOBase
    from sparsebase_tpu.convert import coo_to_csr
    from sparsebase_tpu.ops.reorder.rcm import RCMReorder
    from sparsebase_tpu.parallel import ShardedCSR, halo, make_mesh

    assert len(jax.devices()) >= 8, "need XLA_FLAGS=--xla_force_host_platform_device_count=8"
    mesh = make_mesh(8)

    graphs = {}
    # ash958 is rectangular (958x292); the committed golden copy is its
    # symmetrized adjacency, deduplicated here before sharding
    ash = IOBase.read_mtx_to_csr(str(REPO / "tests" / "golden" / "ash958_sym.mtx"))
    ar = np.asarray(ash.row_of_nnz(), dtype=np.int64)
    ac = np.asarray(ash.indices, dtype=np.int64)
    ns = ash.nrows
    sym_keys = np.unique(np.concatenate([ar * ns + ac, ac * ns + ar]))
    graphs["ash958(sym)"] = coo_to_csr(COO.new(
        (sym_keys // ns).astype(np.int32), (sym_keys % ns).astype(np.int32),
        None, shape=(ns, ns)))
    rng = np.random.default_rng(0)
    n = 20000
    nnz = n * 8
    row = rng.integers(0, n, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    keep = row != col
    row, col = row[keep], col[keep]
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    keys = np.unique(row * n + col)
    graphs["rand-20k"] = coo_to_csr(COO.new(
        (keys // n).astype(np.int32), (keys % n).astype(np.int32), None,
        shape=(n, n)))

    for name, csr in graphs.items():
        host_order = np.asarray(RCMReorder().get_reorder(csr))
        host_bw = bandwidth_of(csr, host_order)
        nat_bw = bandwidth_of(csr, np.arange(csr.nrows))
        print(f"\n== {name}: n={csr.nrows} nnz={csr.nnz} "
              f"natural bw={nat_bw} host RCM bw={host_bw}")
        sh = ShardedCSR.from_csr(csr, mesh, halo=True)
        configs = [
            dict(refine_iters=0),
            dict(refine_iters=2),
            dict(refine_iters=4),
            dict(refine_iters=8),
            dict(refine_iters=16),
            dict(refine_iters=32),
            dict(refine_iters=8, deg_buckets=256),
            dict(refine_iters=8, parent_buckets=1024),
            dict(refine_iters=16, deg_buckets=256, parent_buckets=1024),
            dict(refine_iters=32, deg_buckets=256, parent_buckets=1024),
        ]
        print(f"{'config':44s} {'bw':>8s} {'vs host':>8s} {'sec':>7s}")
        for cfg in configs:
            t0 = time.perf_counter()
            order = np.asarray(halo.rcm_reorder(sh, mesh, **cfg))
            dt = time.perf_counter() - t0
            bw = bandwidth_of(csr, order)
            label = ",".join(f"{k}={v}" for k, v in cfg.items())
            print(f"{label:44s} {bw:8d} {bw/max(host_bw,1):8.3f} {dt:7.2f}")


if __name__ == "__main__":
    main()
