"""Distributed preprocessing over a device mesh (multi-device layer; no
reference analogue — SURVEY.md §2.13 north star).

Run with virtual devices on CPU:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/distributed_mesh.py
"""

import numpy as np

from _common import load_symmetric_graph, parse_args

import jax
import jax.numpy as jnp

from sparsebase_tpu.parallel import (
    ShardedCSR,
    bfs_levels,
    degree_reorder,
    label_prop_partition,
    make_mesh,
    spmv,
)


def main():
    args = parse_args(__doc__)
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} device(s)")

    g = load_symmetric_graph(args.matrix)
    import dataclasses

    g = dataclasses.replace(g, vals=np.ones(g.nnz, np.float32))
    sh = ShardedCSR.from_csr(g, mesh)
    print("sharded:", sh)

    x = jnp.ones((g.ncols,), jnp.float32)
    y = spmv(sh, x, mesh)
    print("sharded SpMV == row degrees:", bool(
        np.allclose(np.asarray(y), np.diff(np.asarray(g.indptr)))
    ))

    levels = np.asarray(bfs_levels(sh, 0, mesh))
    print("BFS levels: reached", int((levels >= 0).sum()), "of", g.nrows)

    order = np.asarray(degree_reorder(sh, mesh))
    print("distributed degree reorder valid:", sorted(order.tolist()) == list(range(g.nrows)))

    labels = np.asarray(label_prop_partition(sh, 4, mesh, num_iters=8))
    print("distributed 4-way partition sizes:", np.bincount(labels, minlength=4).tolist())


if __name__ == "__main__":
    main()
