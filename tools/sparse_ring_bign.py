"""Sparse-ring parity at a size the dense ring refuses (VERDICT r3
item 5 'Done' criterion): n >= 1e5 on the 8-device CPU mesh, where
rows·n_pad = 2.1e9 elements > MAX_DENSE_ELEMS (the dense tier would
need ~4.3 GB of bf16 tile per device). Verifies the sparse ring's
triangle count and Jaccard weights against the host binary-search
implementations and prints the budget/width sizing as JSON.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/sparse_ring_bign.py
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
    assert len(jax.devices()) >= 8

    from sparsebase_tpu.formats.csr import CSR
    from sparsebase_tpu.ops.feature.jaccard import _jaccard_host
    from sparsebase_tpu.ops.feature.triangles import _undirected_count
    from sparsebase_tpu.parallel import ShardedCSR, make_mesh, ring

    n = 131072
    avg = 8
    rng = np.random.default_rng(0)
    r = rng.integers(0, n, n * avg // 2)
    c = rng.integers(0, n, n * avg // 2)
    keep = r != c
    r, c = r[keep], c[keep]
    r2 = np.concatenate([r, c]).astype(np.int64)
    c2 = np.concatenate([c, r]).astype(np.int64)
    keys = np.unique(r2 * n + c2)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(row, minlength=n))]
    ).astype(np.int32)
    csr = CSR(indptr, col, None, (n, n))
    nnz = csr.nnz
    mesh = make_mesh(8)
    sh = ShardedCSR.from_csr(csr, mesh, halo=False)

    d, rows = sh.n_shards, sh.rows_per_shard
    dense_elems = rows * d * rows
    res = {
        "n": n,
        "nnz": int(nnz),
        "devices": d,
        "dense_tile_elems": int(dense_elems),
        "dense_guard": int(ring.MAX_DENSE_ELEMS),
        "dense_refuses": bool(dense_elems > ring.MAX_DENSE_ELEMS),
    }
    assert res["dense_refuses"], "fixture must exceed the dense guard"

    wmax, budget = ring._sparse_sizes(sh, mesh)
    res["wmax"] = int(wmax)
    res["budget"] = int(budget)

    t0 = time.perf_counter()
    tri = ring.triangle_count(sh, mesh)  # auto-falls back to sparse
    res["triangles_sparse_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    tri_host = _undirected_count(csr)
    res["triangles_host_s"] = round(time.perf_counter() - t0, 2)
    res["triangles"] = int(tri)
    res["triangles_match_host"] = bool(tri == tri_host)
    print(f"triangles: sparse {tri} host {tri_host}", flush=True)

    t0 = time.perf_counter()
    flat = ring.jaccard_flat(sh, mesh)
    res["jaccard_sparse_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    want = _jaccard_host(csr)
    res["jaccard_host_s"] = round(time.perf_counter() - t0, 2)
    res["jaccard_match_host"] = bool(
        np.allclose(flat, want, rtol=0, atol=1e-6)
    )
    res["ok"] = res["triangles_match_host"] and res["jaccard_match_host"]
    print(json.dumps(res, indent=1))
    assert res["ok"]


if __name__ == "__main__":
    main()
