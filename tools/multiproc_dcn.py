"""Multi-process (DCN-analogue) execution of the distributed tier
(VERDICT r3 item 4 / SURVEY §2.13 "multi-host DCN maps to
jax.distributed").

Phase 1 (parent, single process, 8 virtual CPU devices): computes the
reference results — distributed ingest checksum, halo SpMV output, RCM
bandwidth — and per-step wall clock.

Phase 2: spawns TWO processes × 4 virtual CPU devices wired through
``jax.distributed.initialize`` (gRPC coordinator — the DCN stand-in).
The same mesh-sharded code runs unchanged over the 2-process global
mesh: distributed ingest (all_to_all crosses the process boundary),
halo SpMV, distributed RCM. Rank 0 writes its results; the parent
checks exact parity with phase 1 and records the cross-process
collective step times next to the single-process ones.

Prints the report as JSON. Usage: python tools/multiproc_dcn.py
(child mode: --rank R --port P, spawned internally).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

N = int(os.environ.get("MULTIPROC_N", 4096))
AVG_DEG = 8
SEED = 42


def make_graph():
    """Deterministic symmetric graph, row-major sorted (replicated in
    every process; each process *reads* only its ingest slice)."""
    rng = np.random.default_rng(SEED)
    nnz0 = N * AVG_DEG // 2
    r = rng.integers(0, N, nnz0)
    c = rng.integers(0, N, nnz0)
    keep = r != c
    r, c = r[keep], c[keep]
    r2 = np.concatenate([r, c])
    c2 = np.concatenate([c, r])
    keys = np.unique(r2.astype(np.int64) * N + c2)
    row = (keys // N).astype(np.int32)
    col = (keys % N).astype(np.int32)
    vals = rng.standard_normal(len(row)).astype(np.float32)
    return row, col, vals


def run_tier(mesh, row, col, vals, x, label):
    """Distributed ingest → halo build → SpMV → RCM; returns results +
    step timings (dict). Identical code for 1-proc and 2-proc runs."""
    import jax

    from sparsebase_tpu.parallel import dist, halo
    from sparsebase_tpu.parallel.sharded import ShardedCSR

    def fetch(a):
        try:
            return np.asarray(jax.device_get(a))
        except Exception:
            from jax.experimental import multihost_utils

            return np.asarray(multihost_utils.process_allgather(a, tiled=True))

    t = {}
    t0 = time.perf_counter()
    sh = ShardedCSR.from_coo_sharded(row, col, vals, (N, N), mesh)
    t["ingest_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    sh = sh.with_halo()
    t["halo_build_s"] = round(time.perf_counter() - t0, 3)

    import jax.numpy as jnp

    xj = jnp.asarray(x)
    y = halo.spmv(sh, xj, mesh)  # compile
    y = fetch(y).reshape(-1)[:N]
    t0 = time.perf_counter()
    for _ in range(20):
        yy = halo.spmv(sh, xj, mesh)
    jax.block_until_ready(yy)
    t["spmv_step_ms"] = round((time.perf_counter() - t0) / 20 * 1e3, 2)

    t0 = time.perf_counter()
    order = dist.rcm_reorder(sh, mesh)
    order = fetch(order).reshape(-1)[:N]
    t["rcm_s"] = round(time.perf_counter() - t0, 3)

    # bandwidth of the reordered matrix (host check)
    ro = order.astype(np.int64)
    bw = int(np.abs(ro[row.astype(np.int64)] - ro[col.astype(np.int64)]).max())
    nnz_total = int(sh.nnz)
    comm = int(sh.halo_bytes_per_exchange)
    return {
        "label": label,
        "nnz": nnz_total,
        "halo_bytes_per_exchange": comm,
        "y_checksum": float(np.abs(y).sum()),
        "y": y,
        "rcm_bandwidth": bw,
        "order_valid": bool(np.array_equal(np.sort(ro), np.arange(N))),
        "timings": t,
    }


def child(rank: int, port: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=rank,
    )
    assert jax.process_count() == 2, "distributed init failed"
    assert len(jax.devices()) == 8, f"global devices {len(jax.devices())}"

    from sparsebase_tpu.parallel import multihost

    mesh = multihost.global_mesh()
    row, col, vals = make_graph()
    rng = np.random.default_rng(7)
    x = rng.standard_normal(N).astype(np.float32)
    res = run_tier(mesh, row, col, vals, x, "2proc_x_4dev")
    if rank == 0:
        res["process_count"] = int(jax.process_count())
        np.save("/tmp/multiproc_y.npy", res.pop("y"))
        Path("/tmp/multiproc_child.json").write_text(
            json.dumps(res, default=str)
        )
    # keep the group alive until both finish
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("done")


def parent():
    # phase 1: single-process reference on 8 virtual devices
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    ref_script = (
        "import sys, json, numpy as np; sys.path.insert(0, %r);\n"
        "import jax; jax.config.update('jax_platforms','cpu');\n"
        "from jax.sharding import Mesh;\n"
        "import tools.multiproc_dcn as M;\n"
        "mesh = Mesh(np.array(jax.devices()), ('x',));\n"
        "row, col, vals = M.make_graph();\n"
        "x = np.random.default_rng(7).standard_normal(M.N).astype(np.float32);\n"
        "res = M.run_tier(mesh, row, col, vals, x, '1proc_x_8dev');\n"
        "np.save('/tmp/multiproc_ref_y.npy', res.pop('y'));\n"
        "open('/tmp/multiproc_ref.json','w').write(json.dumps(res, default=str))\n"
    ) % str(REPO)
    print("[phase 1] single-process reference...", flush=True)
    subprocess.run([sys.executable, "-c", ref_script], env=env, check=True, cwd=REPO)
    ref = json.loads(Path("/tmp/multiproc_ref.json").read_text())

    # phase 2: two processes x 4 devices via jax.distributed
    port = 49731
    env2 = dict(os.environ)
    env2["XLA_FLAGS"] = (
        env2.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
    ).strip()
    print("[phase 2] 2 processes x 4 devices over jax.distributed...", flush=True)
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--port", str(port)],
            env=env2,
            cwd=REPO,
        )
        for r in (0, 1)
    ]
    codes = [p.wait(timeout=1200) for p in procs]
    assert codes == [0, 0], f"child exit codes {codes}"
    got = json.loads(Path("/tmp/multiproc_child.json").read_text())

    y_ref = np.load("/tmp/multiproc_ref_y.npy")
    y_got = np.load("/tmp/multiproc_y.npy")
    y_match = bool(np.allclose(y_ref, y_got, rtol=1e-5, atol=1e-5))
    report = {
        "ok": bool(
            y_match
            and got["rcm_bandwidth"] == ref["rcm_bandwidth"]
            and got["nnz"] == ref["nnz"]
            and got["order_valid"]
        ),
        "n": N,
        "nnz": ref["nnz"],
        "y_match": y_match,
        "rcm_bandwidth_1proc": ref["rcm_bandwidth"],
        "rcm_bandwidth_2proc": got["rcm_bandwidth"],
        "halo_bytes_per_exchange": ref["halo_bytes_per_exchange"],
        "timings_1proc": ref["timings"],
        "timings_2proc": got["timings"],
        "note": (
            "identical mesh code; phase-2 collectives cross a gRPC process "
            "boundary (DCN analogue). Step-time ratio 2proc/1proc bounds the "
            "cross-process collective overhead on this host."
        ),
    }
    print(json.dumps(report, indent=1))
    assert report["ok"], "multi-process parity FAILED"


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank = int(sys.argv[sys.argv.index("--rank") + 1])
        port = int(sys.argv[sys.argv.index("--port") + 1])
        child(rank, port)
    else:
        parent()
