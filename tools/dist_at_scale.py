"""Distributed tier at a size where the sizing logic is load-bearing
(VERDICT r3 item 3): >=2M nnz, zipf-skewed, 8-device CPU mesh, through
the full chain

  from_coo_sharded (two-pass routing buffer)
  -> balanced layout (serpentine deal)
  -> with_halo (device halo builder, pow2 histograms)
  -> halo SpMV (parity vs scipy)
  -> distributed RCM + SlashBurn + multilevel V-cycle

asserting int32 arithmetic, buffer sizing and parity hold, and
recording wall clock + comm bytes. Prints the result as JSON.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/dist_at_scale.py [nnz_M (default 2.5)]
"""

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np



def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    assert len(jax.devices()) >= 8, "need XLA_FLAGS=--xla_force_host_platform_device_count=8"

    from sparsebase_tpu.convert import coo_to_csr
    from sparsebase_tpu.formats.coo import COO
    from sparsebase_tpu.parallel import dist, halo, make_mesh
    from sparsebase_tpu.parallel.sharded import ShardedCSR, balanced_row_order
    

    nnz_m = float(sys.argv[1]) if len(sys.argv) > 1 else 2.5
    target = int(nnz_m * 1e6)
    n = max(target // 8, 1)
    rng = np.random.default_rng(0)
    # zipf-skewed rows (the shape the serpentine deal + pow2 histograms
    # were built for), symmetric so RCM/SlashBurn semantics hold
    zr = rng.zipf(1.25, target)
    zr = zr[zr <= n] - 1
    zc = rng.integers(0, n, len(zr))
    r2 = np.concatenate([zr, zc])
    c2 = np.concatenate([zc, zr])
    keep = r2 != c2
    r2, c2 = r2[keep], c2[keep]
    keys = np.unique(r2.astype(np.int64) * n + c2.astype(np.int64))
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    vals = rng.standard_normal(len(row)).astype(np.float32)
    nnz = len(row)
    res = {"n": n, "nnz": nnz, "devices": 8}
    print(f"graph: n={n} nnz={nnz} max_deg={np.bincount(row).max()}", flush=True)

    mesh = make_mesh(8)
    t0 = time.perf_counter()
    sh0 = ShardedCSR.from_coo_sharded(row, col, vals, (n, n), mesh)
    res["ingest_s"] = round(time.perf_counter() - t0, 2)
    assert int(sh0.nnz) == nnz, (sh0.nnz, nnz)
    res["ingest_width_ratio"] = round(
        sh0.indices.shape[1] * 8 / max(nnz, 1), 3
    )

    # balanced relabel (host order; applied to the host CSR, then shard)
    csr = coo_to_csr(COO(row, col, vals, (n, n)))
    t0 = time.perf_counter()
    order = balanced_row_order(csr, 8)
    from sparsebase_tpu.bases import ReorderBase

    csr_b = ReorderBase.permute2d(order, csr)
    res["balance_relabel_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    sh = ShardedCSR.from_csr(csr_b, mesh, halo=False)
    res["shard_s"] = round(time.perf_counter() - t0, 2)
    res["padded_width_ratio_natural"] = round(
        ShardedCSR.from_csr(csr, mesh, halo=False).padded_width_ratio(), 2
    )
    res["padded_width_ratio_balanced"] = round(sh.padded_width_ratio(), 2)

    t0 = time.perf_counter()
    sh = sh.with_halo()  # device halo builder at load-bearing size
    res["halo_build_s"] = round(time.perf_counter() - t0, 2)
    res["halo_bytes_per_exchange"] = int(sh.halo_bytes_per_exchange)
    res["dense_psum_bytes_per_step"] = 4 * n * 8

    # SpMV parity vs scipy at full size
    import scipy.sparse as sp

    x = rng.standard_normal(n).astype(np.float32)
    t0 = time.perf_counter()
    y = np.asarray(jax.device_get(halo.spmv(sh, jnp.asarray(x), mesh))).reshape(-1)[:n]
    res["spmv_first_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    for _ in range(5):
        yy = halo.spmv(sh, jnp.asarray(x), mesh)
    jax.block_until_ready(yy)
    res["spmv_step_s"] = round((time.perf_counter() - t0) / 5, 3)
    m = sp.csr_matrix(
        (np.asarray(csr_b.vals), np.asarray(csr_b.indices), np.asarray(csr_b.indptr)),
        shape=(n, n),
    )
    ok = np.allclose(y, m @ x, rtol=2e-3, atol=2e-3)
    res["spmv_parity"] = bool(ok)
    print(f"spmv parity: {ok}", flush=True)

    # distributed RCM (halo BFS + counting rank) at scale
    t0 = time.perf_counter()
    ro = np.asarray(jax.device_get(dist.rcm_reorder(sh, mesh))).reshape(-1)[:n]
    res["rcm_s"] = round(time.perf_counter() - t0, 2)
    res["rcm_order_valid"] = bool(np.array_equal(np.sort(ro), np.arange(n)))
    bw_nat = int(np.abs(row.astype(np.int64) - col.astype(np.int64)).max())
    rr = ro[np.asarray(csr_b.row_of_nnz(), np.int64)]
    cc = ro[np.asarray(csr_b.indices, np.int64)]
    res["rcm_bandwidth"] = int(np.abs(rr - cc).max())
    res["natural_bandwidth"] = bw_nat
    print(f"rcm: {res['rcm_s']}s bw {bw_nat} -> {res['rcm_bandwidth']}", flush=True)

    # distributed SlashBurn (round 5): hybrid default (device rounds +
    # host-sized-residual handoff) and the pure-distributed mode
    # (geometric compaction, no host tiers) — orders must be identical
    t0 = time.perf_counter()
    sb_order = np.asarray(
        jax.device_get(halo.slashburn_reorder(sh, mesh, k_size=64))
    ).reshape(-1)[:n]
    res["slashburn_s"] = round(time.perf_counter() - t0, 2)
    res["slashburn_order_valid"] = bool(
        np.array_equal(np.sort(sb_order), np.arange(n))
    )
    t0 = time.perf_counter()
    sb_pure = np.asarray(
        jax.device_get(
            halo.slashburn_reorder(sh, mesh, k_size=64, host_tail=0,
                                   host_tail_nnz=0)
        )
    ).reshape(-1)[:n]
    res["slashburn_pure_dist_s"] = round(time.perf_counter() - t0, 2)
    res["slashburn_modes_match"] = bool(np.array_equal(sb_order, sb_pure))
    print(
        f"slashburn: hybrid {res['slashburn_s']}s / pure-dist "
        f"{res['slashburn_pure_dist_s']}s valid={res['slashburn_order_valid']} "
        f"match={res['slashburn_modes_match']}",
        flush=True,
    )

    # multilevel V-cycle partition at scale
    t0 = time.perf_counter()
    labels = np.asarray(
        jax.device_get(halo.multilevel_partition(sh, 8, mesh))
    ).reshape(-1)[:n]
    res["vcycle_s"] = round(time.perf_counter() - t0, 2)
    assert labels.min() >= 0 and labels.max() < 8
    cut = int(np.asarray(jax.device_get(dist.edge_cut(sh, jnp.asarray(labels), mesh))).reshape(-1)[0])
    rand_cut = int(
        np.asarray(
            jax.device_get(
                dist.edge_cut(
                    sh,
                    jnp.asarray(rng.integers(0, 8, n).astype(np.int32)),
                    mesh,
                )
            )
        ).reshape(-1)[0]
    )
    res["vcycle_cut"] = cut
    res["random_cut"] = rand_cut
    sizes = np.bincount(labels, minlength=8)
    res["vcycle_balance"] = round(float(sizes.max() / (n / 8)), 3)
    print(f"vcycle: {res['vcycle_s']}s cut {cut} vs random {rand_cut}", flush=True)

    res["ok"] = bool(
        ok
        and res["rcm_order_valid"]
        and res["slashburn_order_valid"]
        and res["slashburn_modes_match"]
        and cut < rand_cut
    )
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
