"""Boundary-proportional distributed kernels via halo exchange
(multi-device layer; no reference analogue — SURVEY.md §2.13 north star,
round-2 scalability work).

Each step ships only the vertex values neighboring shards actually
read (one all_to_all of the precomputed halo lists) instead of a dense
(n,) psum; comm volume is proportional to the partition boundary.

Run with virtual devices on CPU:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/halo_exchange.py
"""

import numpy as np

from _common import load_symmetric_graph, parse_args

import jax
import jax.numpy as jnp

from sparsebase_tpu.parallel import ShardedCSR, halo, make_mesh


def main():
    args = parse_args(__doc__)
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} device(s)")

    g = load_symmetric_graph(args.matrix)
    import dataclasses

    g = dataclasses.replace(g, vals=np.ones(g.nnz, np.float32))
    # distributed ingest: route COO entries to their row-block owners
    # with one all_to_all — no single-host CSR required
    from sparsebase_tpu.convert import csr_to_coo

    coo = csr_to_coo(g)
    sh = ShardedCSR.from_coo_sharded(coo.row, coo.col, coo.vals, coo.shape, mesh)
    sh = sh.with_halo()
    print("sharded:", sh)
    print(
        f"halo exchange: {halo.step_comm_bytes(sh)} B/step vs "
        f"{4 * g.nrows * n_dev} B/step for a dense (n,) psum"
    )

    x = jnp.ones((g.ncols,), jnp.float32)
    y = halo.spmv(sh, x, mesh)
    print("halo SpMV == row degrees:", bool(
        np.allclose(np.asarray(y), np.diff(np.asarray(g.indptr)))
    ))

    levels = np.asarray(halo.bfs_levels(sh, 0, mesh))
    print("halo BFS: reached", int((levels >= 0).sum()), "of", g.nrows)

    order = np.asarray(halo.rcm_reorder(sh, mesh))
    r = np.repeat(np.arange(g.nrows), np.diff(np.asarray(g.indptr)))
    c = np.asarray(g.indices)
    print(
        "distributed RCM bandwidth:",
        int(np.abs(r - c).max()), "->", int(np.abs(order[r] - order[c]).max()),
    )

    labels = np.asarray(halo.label_prop_partition(sh, 4, mesh, num_iters=8))
    print("halo 4-way partition sizes:", np.bincount(labels, minlength=4).tolist())


if __name__ == "__main__":
    main()
