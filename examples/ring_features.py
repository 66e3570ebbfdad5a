"""Ring-collective matmul features + distributed components/SlashBurn
(multi-device layer; the reference computes Jaccard on one GPU —
feature/jaccard_weights_cuda.cu — and triangles/SlashBurn sequentially).

Neighborhood intersections are entries of A·Aᵀ / A², so the distributed
kernels densify row blocks to bf16 tiles and rotate them around the mesh
with ``lax.ppermute`` (ring collective matmul). Connected components and
SlashBurn run over the halo (all_to_all) tier.

Run with virtual devices on CPU:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/ring_features.py
"""

import numpy as np

from _common import load_symmetric_graph, parse_args

import jax

from sparsebase_tpu.ops.feature import JaccardWeights, TriangleCount
from sparsebase_tpu.parallel import ShardedCSR, halo, make_mesh, ring


def main():
    args = parse_args(__doc__)
    mesh = make_mesh(len(jax.devices()))
    print(f"mesh: {mesh.size} device(s)")

    g = load_symmetric_graph(args.matrix)
    sh = ShardedCSR.from_csr(g, mesh, halo=True)

    tri = ring.triangle_count(sh, mesh)
    tri_host = TriangleCount().get_triangle_count(g)
    print(f"triangles (ring matmul): {tri}   host: {tri_host}")
    assert tri == tri_host

    jac = ring.jaccard_flat(sh, mesh)
    jac_host = np.asarray(JaccardWeights().get_jaccard_weights(g).vals)
    print(f"jaccard: {len(jac)} edge weights, max {jac.max():.3f}")
    assert np.allclose(jac, jac_host, atol=1e-6)

    cc = np.asarray(jax.device_get(halo.connected_components(sh, mesh)))
    print(f"connected components: {len(np.unique(cc))}")

    order = np.asarray(halo.slashburn_reorder(sh, mesh, k_size=32))
    assert sorted(order.tolist()) == list(range(g.nrows))
    print(f"distributed SlashBurn: valid permutation over {g.nrows} vertices")


if __name__ == "__main__":
    main()
