"""Headline benchmark: sparse preprocessing throughput on one GPU.

Times the canonical end-to-end slice, ``models.preprocess_pipeline``:
COO→CSR conversion + degree reorder + symmetric row/col permutation +
SpMV, one jitted device program, on the synthetic power-law graph of
:func:`make_graph_on_device` at 100M nnz (n = nnz/16). Compilation is
reported apart from the steady run; each timed run ends in
``block_until_ready``.

Runs only on a GPU: with no GPU it exits non-zero and prints no result.

    python bench.py [nnz_millions]

Prints the device and the card's name and power limit, then ONE JSON
line: {"metric", "value", "unit", "device", "card", ...}.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import numpy as np


def make_graph(n, avg_deg, seed=0):
    """Host-side synthetic skewed graph (used by tests/drives)."""
    rng = np.random.default_rng(seed)
    nnz = n * avg_deg
    # skewed (power-law-ish) targets: mix uniform + preferential clump
    row = rng.integers(0, n, nnz).astype(np.int64)
    col = np.where(
        rng.random(nnz) < 0.2,
        rng.integers(0, max(n // 100, 1), nnz),
        rng.integers(0, n, nnz),
    ).astype(np.int64)
    keys = np.unique(row * n + col)
    row = (keys // n).astype(np.int32)
    col = (keys % n).astype(np.int32)
    vals = rng.standard_normal(len(row)).astype(np.float32)
    return row, col, vals


def make_graph_on_device(n, nnz, seed=0):
    """Generate a row-major-sorted synthetic COO entirely on the device.

    The same skew as :func:`make_graph` (20% of columns in a clump of
    n/100 hubs), made where it is used: a 100M-nnz COO is 1.2 GB, and
    generating it on the device keeps the host-to-device copy out of
    set-up. Duplicate (row, col) entries are possible and kept."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        row = jax.random.randint(k1, (nnz,), 0, n, dtype=jnp.int32)
        clump = jax.random.randint(k2, (nnz,), 0, max(n // 100, 1), dtype=jnp.int32)
        uniform = jax.random.randint(k3, (nnz,), 0, n, dtype=jnp.int32)
        col = jnp.where(jax.random.uniform(k4, (nnz,)) < 0.2, clump, uniform)
        vals = jax.random.normal(k1, (nnz,), jnp.float32)
        # row-major order: one fused variadic sort
        row_s, col_s, vals_s = jax.lax.sort((row, col, vals), num_keys=2)
        return row_s, col_s, vals_s

    return gen(jax.random.PRNGKey(seed))


def main():
    from sparsebase_tpu.utils.device_run import (
        NoGPUError,
        card_name_and_power_limit,
        device_record,
        peak_bytes,
        require_gpu,
        use_compile_cache,
    )

    try:
        devices = require_gpu()
    except NoGPUError as e:
        sys.exit(f"bench.py: {e}")
    use_compile_cache()
    import jax
    import jax.numpy as jnp

    import sparsebase_tpu as sb
    from sparsebase_tpu.models import preprocess_pipeline

    nnz = int(float(sys.argv[1]) * 1e6) if len(sys.argv) > 1 else 100_000_000
    n = max(nnz // 16, 1)
    row, col, vals = make_graph_on_device(n, nnz)
    coo = sb.COO(row, col, vals, (n, n))
    x = jnp.ones((n,), jnp.float32)

    fn = jax.jit(preprocess_pipeline)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(coo, x))
    compile_s = time.perf_counter() - t0
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(coo, x)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    card = card_name_and_power_limit()
    device = device_record(devices)
    print(f"device: {device}  card: {card}")
    print(
        json.dumps(
            {
                "metric": "preprocess_pipeline_throughput",
                "value": nnz / dt,
                "unit": "nnz/s",
                "nnz": nnz,
                "n": n,
                "step_s": dt,
                "first_call_s": compile_s,
                "peak_bytes_in_use": peak_bytes(devices[0]),
                "device": device,
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()
