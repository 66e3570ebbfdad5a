"""Jitted SpMV with reorder comparison on the device (reference:
tutorials/004_cuda_spmv — the CUDA SpMV tutorial). Run with --device for
the GPU."""

import time

import numpy as np

from _common import load_symmetric_graph, parse_args

import jax
import jax.numpy as jnp

import sparsebase_tpu as sb
from sparsebase_tpu.bases import ReorderBase
from sparsebase_tpu.models import spmv_csr
from sparsebase_tpu.ops.reorder import GrayReorder, RCMReorder


def time_spmv(csr, reps=10):
    vals = np.ones(csr.nnz, np.float32)
    import dataclasses

    c = dataclasses.replace(csr, vals=vals).to_device()
    x = jnp.ones((csr.ncols,), jnp.float32)
    f = jax.jit(spmv_csr)
    jax.block_until_ready(f(c, x))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        y = f(c, x)
    jax.block_until_ready(y)
    return (time.perf_counter() - t0) / reps


def main():
    args = parse_args(__doc__)
    g = load_symmetric_graph(args.matrix)
    results = {"natural": time_spmv(g)}
    for name, op in [("gray", GrayReorder()), ("rcm", RCMReorder())]:
        order = op.get_reorder(g)
        results[name] = time_spmv(ReorderBase.permute2d(order, g))
    for name, secs in results.items():
        print(f"SpMV {name:8s}: {secs * 1e6:9.1f} us")


if __name__ == "__main__":
    main()
