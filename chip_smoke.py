"""Smoke run of the main path on one GPU, at sizes users would call real.

    python chip_smoke.py            # phases A-E on one GPU
    python chip_smoke.py --four     # the distributed tier on four GPUs only

Phases (each prints one ``phase <X>: {json}`` line with its sizes, the
first call's seconds (compile included) apart from the steady run's,
``peak_bytes_in_use`` so far, and its largest error beside the
tolerance):

  A. ``models.preprocess_pipeline`` (COO→CSR→degree reorder→symmetric
     permute→SpMV) on ``bench.make_graph_on_device``'s power-law graph,
     checked against a plain-JAX reference on the device at full size and
     against scipy (float64) at 1M nnz.
  B. The facade path on HPCG's 27-point operator (scrambled labels):
     device RCM through ``ReorderBase``, ``permute2d``, ``pipelines.spmv``
     on CSR; then the unscrambled operator through the DIA dispatch.
  C. ``TriangleCount`` and ``JaccardWeights`` on the device, on the
     dense/flat tier and on the sparse tier, exact against the native host
     kernels.
  D. DIA SpMV (``banded_spmv``) timing: bytes/s over the minimal bytes,
     beside a plain device copy.
  E. Ingest: MTX written by ``MTXWriter``, read by the native reader,
     moved to the device, equal to the numpy reader's result.

The process holds the card alone; ``nvidia-smi`` runs as a child that
never imports JAX. With no GPU the script exits non-zero at once and
prints no result. Any failed check exits non-zero without the last line.
The last line is the JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import numpy as np

from sparsebase_tpu.utils.device_run import (
    NoGPUError,
    card_name_and_power_limit,
    device_record,
    peak_bytes,
    require_gpu,
    use_compile_cache,
)

EPS32 = float(np.finfo(np.float32).eps)


class SmokeFailure(AssertionError):
    """A phase's result is outside its stated tolerance."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed(fn, *args, steady_reps=1):
    """Run ``fn`` once cold (compile included) and ``steady_reps`` times
    warm; every run ends in ``block_until_ready``. Returns
    ``(out, first_s, steady_s)``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steady_reps):
        out = jax.block_until_ready(fn(*args))
    steady = (time.perf_counter() - t0) / max(steady_reps, 1)
    return out, first, steady


def _peak():
    import jax

    return peak_bytes(jax.devices()[0])


def cumsum_atol(nnz, prefix_max):
    """Tolerance for a row sum read off a global f32 prefix sum.

    y_i = run[e] - run[s]. A parallel scan forms each prefix from at most
    2·log2(nnz) additions of range sums, each range sum bounded by
    2·max|prefix|, so each prefix is off by at most 2·log2(nnz)·eps·M and
    a difference of two by 4·log2(nnz)·eps·M, plus eps·M for the final
    subtraction and rounding of the products. c = 4·⌈log2 nnz⌉ + 1."""
    c = 4 * math.ceil(math.log2(max(nnz, 2))) + 1
    return c * EPS32 * float(prefix_max), c


# ---------------------------------------------------------------------------
# A. headline pipeline
# ---------------------------------------------------------------------------


def _pipeline_reference():
    """Plain-JAX reference of ``preprocess_pipeline``: degree ranks from a
    segment_sum, ``ro[row]``/``ro[col]``, one lexsort (value as the last
    key, so duplicate (row, col) entries come out ordered by value), and
    per-row sums by segment_sum."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def ref(row, col, vals, x):
        n = x.shape[0]
        ones = jnp.ones_like(row)
        deg = jax.ops.segment_sum(ones, row, num_segments=n)
        perm = jnp.argsort(deg, stable=True)
        ro = jnp.zeros((n,), jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))
        new_row, new_col = ro[row], ro[col]
        order = jnp.lexsort((vals, new_col, new_row))
        counts = jax.ops.segment_sum(ones, new_row, num_segments=n)
        indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)])
        prod = vals * x[col]
        y = jax.ops.segment_sum(prod, new_row, num_segments=n)
        prefix_max = jnp.max(jnp.abs(jnp.cumsum(prod)))
        return indptr, new_col[order], vals[order], y, prefix_max

    return ref


def _canonical(indptr, indices, vals):
    """Order the entries of each equal (row, col) run by value."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def canon(indptr, indices, vals):
        nnz = indices.shape[0]
        marks = jnp.zeros((nnz + 1,), jnp.int32).at[indptr[1:-1]].add(1)
        row = jnp.cumsum(marks)[:nnz]
        order = jnp.lexsort((vals, indices, row))
        return indices[order], vals[order]

    return canon(indptr, indices, vals)


def phase_pipeline(n, nnz, scipy_n, scipy_nnz, seed=0):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import sparsebase_tpu as sb
    from bench import make_graph_on_device
    from sparsebase_tpu.models import preprocess_pipeline

    fn = jax.jit(preprocess_pipeline)
    row, col, vals = make_graph_on_device(n, nnz, seed)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,), jnp.float32)
    coo = sb.COO(row, col, vals, (n, n))
    (csr, y), first, steady = timed(fn, coo, x)
    ref_indptr, ref_indices, ref_vals, ref_y, prefix_max = jax.block_until_ready(
        _pipeline_reference()(row, col, vals, x)
    )
    got_indices, got_vals = _canonical(csr.indptr, csr.indices, csr.vals)
    check(bool(jnp.array_equal(csr.indptr, ref_indptr)), "A: indptr differs from the reference")
    check(bool(jnp.array_equal(got_indices, ref_indices)), "A: indices differ from the reference")
    check(bool(jnp.array_equal(got_vals, ref_vals)), "A: vals differ from the reference")
    err = float(jnp.max(jnp.abs(y - ref_y)))
    atol, c = cumsum_atol(nnz, prefix_max)
    check(err <= atol, f"A: y error {err} > atol {atol}")
    rec = {
        "n": n,
        "nnz": nnz,
        "first_s": first,
        "steady_s": steady,
        "nnz_per_s": nnz / steady,
        "peak_bytes_in_use": _peak(),
        "structure": "exact",
        "y_max_err": err,
        "y_atol": atol,
        "atol_c": c,
    }
    del csr, y, coo, row, col, vals, ref_indices, ref_vals, got_indices, got_vals

    # small graph: y against scipy in float64 (duplicates summed)
    row, col, vals = make_graph_on_device(scipy_n, scipy_nnz, seed + 2)
    x = jax.random.normal(jax.random.PRNGKey(seed + 3), (scipy_n,), jnp.float32)
    _, y = fn(sb.COO(row, col, vals, (scipy_n, scipy_n)), x)
    r, c_, v, xh, yh = (np.asarray(a) for a in (row, col, vals, x, y))
    a = sp.csr_matrix((v.astype(np.float64), (r, c_)), shape=(scipy_n, scipy_n))
    deg = np.bincount(r, minlength=scipy_n)
    ro = np.empty(scipy_n, np.int64)
    ro[np.argsort(deg, kind="stable")] = np.arange(scipy_n)
    y_ref = np.empty(scipy_n)
    y_ref[ro] = a @ xh.astype(np.float64)
    prod = v.astype(np.float64) * xh[c_].astype(np.float64)
    atol_s, _ = cumsum_atol(scipy_nnz, np.abs(np.cumsum(prod)).max())
    err_s = float(np.abs(yh - y_ref).max())
    check(err_s <= atol_s, f"A: y vs scipy error {err_s} > atol {atol_s}")
    rec.update(scipy_nnz=scipy_nnz, scipy_y_max_err=err_s, scipy_y_atol=atol_s)
    return rec


# ---------------------------------------------------------------------------
# B. facade path on HPCG's 27-point operator
# ---------------------------------------------------------------------------


def stencil27(g):
    """HPCG's operator on a g³ grid as a (n, 27) column table: diagonal 26,
    every in-grid neighbour of the 3x3x3 cube -1. Returns (cols, valid)
    with the 27 offsets ascending, so the valid entries of each row are
    already in column order."""
    n = g**3
    i = np.arange(n, dtype=np.int64)
    z, rem = np.divmod(i, g * g)
    y, x = np.divmod(rem, g)
    offs = []
    valid = np.empty((n, 27), bool)
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                offs.append(dz * g * g + dy * g + dx)
                valid[:, k] = (
                    (z + dz >= 0) & (z + dz < g) & (y + dy >= 0) & (y + dy < g)
                    & (x + dx >= 0) & (x + dx < g)
                )
                k += 1
    cols = i[:, None] + np.asarray(offs, np.int64)[None, :]
    return cols, valid


def _table_to_csr(cols, valid, n):
    import sparsebase_tpu as sb

    counts = valid.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    idx = cols[valid].astype(np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), counts)
    vals = np.where(idx == rows, np.float32(26.0), np.float32(-1.0))
    return sb.CSR(indptr, idx, vals, (n, n))


def bandwidth(indptr, indices, order=None):
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, np.int64)
    if order is not None:
        order = np.asarray(order, np.int64)
        rows, cols = order[rows], order[cols]
    return int(np.abs(rows - cols).max(initial=0))


def phase_stencil(g, seed=0):
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    import sparsebase_tpu as sb
    from sparsebase_tpu.bases import ReorderBase
    from sparsebase_tpu.models import pipelines

    n = g**3
    cols, valid = stencil27(g)
    nat = _table_to_csr(cols, valid, n)
    # scrambled labels, as bench_suite's mesh graphs scramble them:
    # vertex i becomes perm[i]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    inv = np.argsort(perm)
    big = np.iinfo(np.int64).max
    scols = np.where(valid[inv], perm[np.where(valid, cols, 0)][inv], big)
    scols.sort(axis=1)  # each new row's columns ascending, absent slots last
    scr = _table_to_csr(scols, scols != big, n)
    del cols, valid, scols

    def csr_scipy(c):
        return sp.csr_matrix(
            (np.asarray(c.vals, np.float64), np.asarray(c.indices), np.asarray(c.indptr)),
            shape=c.shape,
        )

    bw_scr = bandwidth(scr.indptr, scr.indices)
    t0 = time.perf_counter()
    host_order = np.asarray(ReorderBase.reorder("rcm", scr))
    host_rcm_s = time.perf_counter() - t0
    bw_host = bandwidth(scr.indptr, scr.indices, host_order)

    dev = scr.to_device()
    order, rcm_first, rcm_steady = timed(lambda c: ReorderBase.reorder("rcm", c), dev)
    check(isinstance(order, jax.Array), "B: device RCM did not return a device array")
    order_h = np.asarray(order, np.int64)
    check(
        np.array_equal(np.bincount(order_h, minlength=n), np.ones(n, np.int64)),
        "B: device RCM order is not a permutation",
    )
    bw_dev = bandwidth(scr.indptr, scr.indices, order_h)
    check(bw_dev <= 2 * bw_host, f"B: device RCM bandwidth {bw_dev} > 2x host {bw_host}")

    permuted, perm_first, perm_steady = timed(lambda o, c: ReorderBase.permute2d(o, c), order, dev)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,), jnp.float32)
    y, spmv_first, spmv_steady = timed(pipelines.spmv, permuted, x)
    # reference in the scrambled labels: y_new[order[i]] = (A x_old)[i]
    xh = np.asarray(x, np.float64)
    a_scr = csr_scipy(scr)
    y_ref = np.empty(n)
    y_ref[order_h] = a_scr @ xh[order_h]
    abs_rows = abs(a_scr) @ np.abs(xh[order_h])
    prefix_max = np.abs(np.cumsum(y_ref)).max() + abs_rows.max()
    atol_csr, _ = cumsum_atol(a_scr.nnz, prefix_max)
    err_csr = float(np.abs(np.asarray(y) - y_ref).max())
    check(err_csr <= atol_csr, f"B: CSR SpMV error {err_csr} > atol {atol_csr}")

    # the unscrambled operator through the DIA dispatch
    nat_dev = nat.to_device()
    dia, dia_conv_first, _ = timed(lambda c: c.convert(sb.DIA), nat_dev, steady_reps=0)
    check(dia.num_diagonals == 27, f"B: DIA has {dia.num_diagonals} diagonals, not 27")
    yd, dia_first, dia_steady = timed(pipelines.spmv, dia, x)
    a_nat = csr_scipy(nat)
    yd_ref = a_nat @ xh
    # sequential f32 sum of 27 products per row: |err_i| <= 27 eps (|A||x|)_i
    bound = 27 * EPS32 * (abs(a_nat) @ np.abs(xh)) + np.finfo(np.float32).tiny
    ratio_dia = float((np.abs(np.asarray(yd) - yd_ref) / bound).max())
    check(ratio_dia <= 1.0, f"B: DIA SpMV error exceeds 27 eps |A||x| (ratio {ratio_dia})")
    rec = {
        "grid": g,
        "n": n,
        "nnz": int(a_nat.nnz),
        "bandwidth_scrambled": bw_scr,
        "bandwidth_host_rcm": bw_host,
        "bandwidth_device_rcm": bw_dev,
        "host_rcm_s": host_rcm_s,
        "device_rcm_first_s": rcm_first,
        "device_rcm_steady_s": rcm_steady,
        "permute2d_first_s": perm_first,
        "permute2d_steady_s": perm_steady,
        "csr_spmv_first_s": spmv_first,
        "csr_spmv_steady_s": spmv_steady,
        "csr_y_max_err": err_csr,
        "csr_y_atol": atol_csr,
        "dia_convert_s": dia_conv_first,
        "dia_spmv_first_s": dia_first,
        "dia_spmv_steady_s": dia_steady,
        "dia_err_over_bound": ratio_dia,
        "peak_bytes_in_use": _peak(),
    }
    return rec, dia


# ---------------------------------------------------------------------------
# C. graph features on the device
# ---------------------------------------------------------------------------


def symmetric_graph(n, avg_deg, seed):
    """``bench.make_graph``'s skewed graph as a simple undirected pattern
    (A ∪ Aᵀ, no self-loops, no duplicates), as a host CSR."""
    import sparsebase_tpu as sb
    from bench import make_graph

    row, col, _ = make_graph(n, avg_deg, seed)
    r = np.concatenate([row, col]).astype(np.int64)
    c = np.concatenate([col, row]).astype(np.int64)
    keep = r != c
    keys = np.unique(r[keep] * n + c[keep])
    counts = np.bincount(keys // n, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return sb.CSR(indptr, (keys % n).astype(np.int32), None, (n, n))


def _features_on(csr, label):
    from sparsebase_tpu import native
    from sparsebase_tpu.ops.feature import JaccardWeights, TriangleCount

    indptr, indices = np.asarray(csr.indptr), np.asarray(csr.indices)
    dev = csr.to_device()
    tri, tri_first, tri_steady = timed(TriangleCount().get_triangle_count, dev)
    jac, jac_first, jac_steady = timed(JaccardWeights().get_jaccard_weights, dev)
    t0 = time.perf_counter()
    tri_ref = native.triangles(csr.nrows, indptr, indices, False)
    jac_ref = native.jaccard(csr.nrows, indptr, indices, csr.nnz)
    host_s = time.perf_counter() - t0
    jac_dev = np.asarray(jac.vals)
    check(int(tri) == tri_ref, f"C/{label}: triangles {tri} != host {tri_ref}")
    mismatch = int((jac_dev != jac_ref).sum())
    check(mismatch == 0, f"C/{label}: {mismatch} Jaccard weights differ from the host kernel")
    return {
        "n": csr.nrows,
        "nnz": csr.nnz,
        "triangles": int(tri),
        "triangles_first_s": tri_first,
        "triangles_steady_s": tri_steady,
        "jaccard_first_s": jac_first,
        "jaccard_steady_s": jac_steady,
        "host_native_s": host_s,
        "jaccard_mismatches": mismatch,
        "peak_bytes_in_use": _peak(),
    }


def phase_features(dense_n, dense_deg, sparse_n, sparse_deg, seed=0):
    from sparsebase_tpu.ops.feature.jaccard import MAX_FLAT_EXPANSION
    from sparsebase_tpu.ops.feature.triangles import MAX_DEVICE_DENSE_N

    def expansion(c):
        return int((np.diff(np.asarray(c.indptr)).astype(np.int64) ** 2).sum())

    dense = symmetric_graph(dense_n, dense_deg, seed)
    check(dense.nrows <= MAX_DEVICE_DENSE_N, "C: dense graph is off the dense tier")
    check(expansion(dense) <= MAX_FLAT_EXPANSION, "C: dense graph is off the flat Jaccard tier")
    sparse = symmetric_graph(sparse_n, sparse_deg, seed + 1)
    check(sparse.nrows > MAX_DEVICE_DENSE_N, "C: sparse graph is on the dense tier")
    check(expansion(sparse) > MAX_FLAT_EXPANSION, "C: sparse graph is on the flat Jaccard tier")
    return {"dense": _features_on(dense, "dense"), "sparse": _features_on(sparse, "sparse")}


# ---------------------------------------------------------------------------
# D. DIA SpMV kernel timing
# ---------------------------------------------------------------------------


def phase_dia(dia, reps, seed=0):
    """``banded_spmv`` (XLA's fused DIA SpMV) on phase B's band, f32 and
    bf16, in bytes/s over the minimal bytes (band once, x once, y once),
    beside the rate of a plain device copy of the band."""
    import jax
    import jax.numpy as jnp

    from sparsebase_tpu.formats.dia import DIA
    from sparsebase_tpu.ops.kernels import banded_spmv, dia_spmv_reference

    n, m = dia.shape
    k = dia.num_diagonals
    x = jax.random.normal(jax.random.PRNGKey(seed), (m,), jnp.float32)

    def best_of_windows(fn, *args, windows=4):
        jax.block_until_ready(fn(*args))
        times = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
            times.append((time.perf_counter() - t0) / reps)
        return min(times), times

    data = jnp.asarray(dia.data, jnp.float32)
    copy_s, _ = best_of_windows(jax.jit(lambda a: a + 1.0), data)
    out = {"n": n, "diagonals": k, "reps": reps, "copy_bytes_per_s": 2 * data.size * 4 / copy_s}
    for dtype in (jnp.float32, jnp.bfloat16):
        band = DIA(dia.offsets, jnp.asarray(dia.data, dtype), dia.shape)
        y = banded_spmv(band, x)
        # the reference sums the same k f32 products per row in another
        # order: |err_i| <= 2 k eps (|A||x|)_i
        bound = 2 * k * EPS32 * dia_spmv_reference(
            DIA(dia.offsets, jnp.abs(band.data), dia.shape), jnp.abs(x)
        ) + np.finfo(np.float32).tiny
        ratio = float(jnp.max(jnp.abs(y - dia_spmv_reference(band, x)) / bound))
        name = jnp.dtype(dtype).name
        check(ratio <= 1.0, f"D: {name} error over bound {ratio}")
        min_bytes = k * n * jnp.dtype(dtype).itemsize + 4 * m + 4 * n
        best, windows = best_of_windows(banded_spmv, band, x)
        out[name] = {
            "min_bytes": min_bytes,
            "err_over_bound": ratio,
            "windows_s": windows,
            "best_s": best,
            "bytes_per_s": min_bytes / best,
            "share_of_copy": min_bytes / best / out["copy_bytes_per_s"],
        }
    out["peak_bytes_in_use"] = _peak()
    return out


# ---------------------------------------------------------------------------
# E. ingest
# ---------------------------------------------------------------------------


def phase_ingest(n, avg_deg, seed=0):
    import jax

    import sparsebase_tpu as sb
    from bench import make_graph
    from sparsebase_tpu import native
    from sparsebase_tpu.bases import IOBase
    from sparsebase_tpu.io import fastio
    from sparsebase_tpu.io.mtx import MTXWriter

    check(fastio.available(), "E: the native parser is not loaded")
    check(native.available(), "E: the native graph kernels are not loaded")
    row, col, vals = make_graph(n, avg_deg, seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "graph.mtx")
        t0 = time.perf_counter()
        MTXWriter(path).write_coo(sb.COO(row, col, vals, (n, n)))
        write_s = time.perf_counter() - t0
        dev, first, steady = timed(lambda p: IOBase.read_pigo_mtx_to_csr(p).to_device(), path)
        t0 = time.perf_counter()
        ref = IOBase.read_mtx_to_csr(path)
        numpy_s = time.perf_counter() - t0
    check(isinstance(dev.indices, jax.Array), "E: the CSR is not on the device")
    for f in ("indptr", "indices", "vals"):
        check(
            np.array_equal(np.asarray(getattr(dev, f)), np.asarray(getattr(ref, f))),
            f"E: {f} differs from the numpy reader's",
        )
    return {
        "n": n,
        "nnz": int(len(row)),
        "mtx_write_s": write_s,
        "read_to_device_first_s": first,
        "read_to_device_steady_s": steady,
        "numpy_reader_s": numpy_s,
        "nnz_per_s": len(row) / steady,
        "peak_bytes_in_use": _peak(),
    }


# ---------------------------------------------------------------------------
# four GPUs: the distributed tier against the single-device path
# ---------------------------------------------------------------------------


def _flatten_padded(padded, counts):
    padded, counts = np.asarray(padded), np.asarray(counts)
    return np.concatenate([padded[i, : counts[i]] for i in range(padded.shape[0])])


def phase_four(n, nnz, feat_n, feat_deg, seed=0):
    """ShardedCSR ingest, halo and dense-psum SpMV, label propagation with
    edge cut, halo RCM, 2-D tiled SpMV, and sparse-ring triangles and
    Jaccard on a 1-D mesh of 4 devices (2x2 for the 2-D tiling), each
    against the single-device result on device 0. Yields one
    (step, record) as each step passes."""
    import jax
    import jax.numpy as jnp

    from bench import make_graph_on_device
    from sparsebase_tpu.convert.kernels import indptr_from_sorted_rows
    from sparsebase_tpu.formats.csr import CSR
    from sparsebase_tpu.models import spmv_csr
    from sparsebase_tpu.ops.feature import JaccardWeights, TriangleCount
    from sparsebase_tpu.parallel import (
        ShardedCSR,
        Sharded2DCSR,
        halo,
        make_mesh,
        make_mesh_2d,
        ring,
        sharded2d,
    )
    from sparsebase_tpu.parallel import spmv as dist_spmv

    devs = jax.devices()[:4]
    mesh = make_mesh(4)
    row, col, vals = make_graph_on_device(n, nnz, seed)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (n,), jnp.float32)
    csr = CSR(indptr_from_sorted_rows(row, n, nnz), col, vals, (n, n))
    y_ref = spmv_csr(csr, x, method="segment")
    deg_max = int(jnp.max(csr.indptr[1:] - csr.indptr[:-1]))
    # two per-row sums of at most deg_max f32 products in other orders
    bound = 2 * deg_max * EPS32 * spmv_csr(
        CSR(csr.indptr, col, jnp.abs(vals), (n, n)), jnp.abs(x), method="segment"
    ) + np.finfo(np.float32).tiny

    sh, ingest_s, _ = timed(
        lambda: ShardedCSR.from_coo_sharded(row, col, vals, (n, n), mesh).with_halo(),
        steady_reps=0,
    )
    check(sh.nnz == nnz, f"4: ingest holds {sh.nnz} entries, not {nnz}")
    width = int(sh.indices.shape[1])
    yield "four/ingest", {"n": n, "nnz": nnz, "mesh": "1-D x4", "ingest_s": ingest_s,
                          "ingest_width": width, "ingest_width_ratio": width * 4 / nnz,
                          "peak_bytes_in_use": [peak_bytes(d) for d in devs]}
    for name, fn in (("halo_spmv", halo.spmv), ("dist_spmv", dist_spmv)):
        y, first, steady = timed(fn, sh, x, mesh)
        ratio = float(jnp.max(jnp.abs(jax.device_put(y, devs[0]) - y_ref) / bound))
        check(ratio <= 1.0, f"4: {name} error over bound {ratio}")
        yield f"four/{name}", {"first_s": first, "steady_s": steady, "err_over_bound": ratio}

    labels, lp_first, _ = timed(lambda: halo.label_prop_partition(sh, 4, mesh), steady_reps=0)
    cut = int(halo.edge_cut(sh, labels, mesh))
    lab0 = jax.device_put(labels, devs[0])
    cut_ref = int(jnp.sum(lab0[row] != lab0[col]))
    sizes = np.bincount(np.asarray(labels), minlength=4)
    check(int(np.asarray(labels).max()) < 4 and sizes.sum() == n, "4: labels out of range")
    check(cut == cut_ref, f"4: edge cut {cut} != single-device count {cut_ref}")
    yield "four/label_prop", {"k": 4, "first_s": lp_first, "edge_cut": cut,
                              "part_sizes": sizes.tolist()}

    order, rcm_first, _ = timed(lambda: halo.rcm_reorder(sh, mesh), steady_reps=0)
    oh = np.asarray(order, np.int64)
    check(np.array_equal(np.bincount(oh, minlength=n), np.ones(n, np.int64)),
          "4: halo RCM order is not a permutation")
    yield "four/halo_rcm", {"first_s": rcm_first, "valid_permutation": True}
    del sh, order, labels, lab0

    mesh2 = make_mesh_2d((2, 2))
    sh2, tile_s, _ = timed(lambda: Sharded2DCSR.from_csr(csr, mesh2), steady_reps=0)
    y2, first, steady = timed(sharded2d.spmv, sh2, x, mesh2)
    ratio = float(jnp.max(jnp.abs(jax.device_put(y2, devs[0]) - y_ref) / bound))
    check(ratio <= 1.0, f"4: 2-D SpMV error over bound {ratio}")
    yield "four/spmv_2d", {"mesh": "2-D (2,2)", "tile_s": tile_s, "first_s": first,
                           "steady_s": steady, "err_over_bound": ratio}
    del sh2, csr, row, col, vals

    sym = symmetric_graph(feat_n, feat_deg, seed + 2)
    shs = ShardedCSR.from_csr(sym, mesh, halo=True)
    dev = jax.device_put(sym, devs[0])
    tri, tri_s, _ = timed(lambda: ring.triangle_count_sparse(shs, mesh), steady_reps=0)
    tri_1 = TriangleCount().get_triangle_count(dev)
    check(int(tri) == int(tri_1), f"4: ring triangles {tri} != single device {tri_1}")
    jac, jac_s, _ = timed(lambda: ring.jaccard_weights_sparse(shs, mesh), steady_reps=0)
    jac_1 = np.asarray(JaccardWeights().get_jaccard_weights(dev).vals)
    mismatch = int((_flatten_padded(jac, shs.nnz_local) != jac_1).sum())
    check(mismatch == 0, f"4: {mismatch} ring Jaccard weights differ from single device")
    yield "four/ring_features", {"n": sym.nrows, "nnz": sym.nnz, "triangles": int(tri),
                                 "triangles_s": tri_s, "jaccard_s": jac_s,
                                 "jaccard_mismatches": mismatch,
                                 "peak_bytes_in_use": [peak_bytes(d) for d in devs]}


FOUR_SIZES = dict(n=6_250_000, nnz=100_000_000, feat_n=500_000, feat_deg=8)


def run_four_gpu(sizes=FOUR_SIZES):
    yield from phase_four(**sizes)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

SIZES = {
    "pipeline": dict(n=6_250_000, nnz=100_000_000, scipy_n=62_500, scipy_nnz=1_000_000),
    "stencil": dict(g=128),
    "features": dict(dense_n=16_384, dense_deg=8, sparse_n=1_000_000, sparse_deg=16),
    "dia_reps": 200,
    "ingest": dict(n=500_000, avg_deg=16),
}


def phase_setup():
    """Build the native host libraries (set-up time, not a phase's)."""
    from sparsebase_tpu import native
    from sparsebase_tpu.io import fastio

    t0 = time.perf_counter()
    check(fastio.available(), "setup: the native parser did not build")
    check(native.available(), "setup: the native graph kernels did not build")
    return {"native_build_s": time.perf_counter() - t0}


def run_one_gpu(sizes=SIZES):
    """Phases A-E; yields (name, record) as each passes."""
    yield "setup", phase_setup()
    yield "A", phase_pipeline(**sizes["pipeline"])
    rec, dia = phase_stencil(**sizes["stencil"])
    yield "B", rec
    yield "C", phase_features(**sizes["features"])
    yield "D", phase_dia(dia, sizes["dia_reps"])
    del dia
    yield "E", phase_ingest(**sizes["ingest"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run the four-GPU phase only")
    args = ap.parse_args(argv)
    try:
        devices = require_gpu()
    except NoGPUError as e:
        sys.exit(f"chip_smoke: {e}")
    if args.four and len(devices) < 4:
        sys.exit(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}")
    cache = use_compile_cache()
    print(f"compile cache: {cache}", flush=True)
    t_start = time.perf_counter()
    phases = run_four_gpu() if args.four else run_one_gpu()
    for name, rec in phases:
        print(f"phase {name}: {json.dumps(rec)}", flush=True)
    print(f"total_s: {time.perf_counter() - t_start}")
    print(f"card: {card_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": device_record(devices)}))


if __name__ == "__main__":
    main()
