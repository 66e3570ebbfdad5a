"""Benchmark suite CLI: quality + throughput tables (BASELINE.md metrics).

Usage::

    python -m sparsebase_tpu.bench_suite [--device] [--out BENCH.md]

Measures, per matrix (bundled ash958 + synthetic graphs):

* conversion throughput (COO↔CSR↔CSC round trip, nnz/s)
* reorder quality: bandwidth/profile reduction per algorithm
* partition quality: edge cut + balance vs a random baseline
* feature extraction timing

This is the "benchmark CLI producing BASELINE.md numbers" of
SURVEY.md §7 phase 6; the reference analogue is the experiment example
(examples/example_experiment).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def _timeit(fn, *args, reps=3):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def synthetic_graph(n, avg_deg, seed=0):
    from .formats.coo import COO
    from .convert import coo_to_csr

    rng = np.random.default_rng(seed)
    nnz = n * avg_deg
    row = rng.integers(0, n, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    keep = row != col
    keys = np.unique(row[keep] * n + col[keep])
    return coo_to_csr(
        COO.new(
            (keys // n).astype(np.int32),
            (keys % n).astype(np.int32),
            None,
            shape=(n, n),
        )
    )


def mesh_graph(side, seed=0, shortcut_frac=0.02):
    """Scrambled 2D mesh (road/mesh class; VERDICT r4 weak #5): a
    4-neighbor lattice plus a few random shortcuts, with vertex ids
    randomly permuted — so the locality exists but must be *recovered*
    by the reorderer. On uniform random graphs the locality reorderers
    legitimately do nothing (rand-20k: gray 19963 vs natural 19915
    bandwidth); this is the structured mid-size input where bandwidth/
    profile quality is demonstrable (RCM should recover O(side))."""
    from .convert import coo_to_csr
    from .formats.coo import COO

    n = side * side
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    right = i[(i % side) < side - 1]
    down = i[i < n - side]
    row = np.concatenate([right, down])
    col = np.concatenate([right + 1, down + side])
    m = int(shortcut_frac * n)
    row = np.concatenate([row, rng.integers(0, n, m)])
    col = np.concatenate([col, rng.integers(0, n, m)])
    # scramble labels
    perm = rng.permutation(n)
    row, col = perm[row], perm[col]
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    keep = row != col
    keys = np.unique(row[keep] * n + col[keep])
    return coo_to_csr(
        COO.new(
            (keys // n).astype(np.int32),
            (keys % n).astype(np.int32),
            None,
            shape=(n, n),
        )
    )


def ash958_graph():
    from .bases import IOBase
    from .formats.coo import COO
    from .formats.csr import CSR

    # the reference's rectangular ash958, symmetrized (A ∪ Aᵀ), as
    # committed with the golden parity outputs
    csr = IOBase.read_mtx_to_csr(
        str(Path(__file__).parent.parent / "tests" / "golden" / "ash958_sym.mtx")
    )
    n = csr.nrows
    coo = csr.convert(COO)
    row = np.asarray(coo.row).astype(np.int64)
    col = np.asarray(coo.col).astype(np.int64)
    # simple graph: dedup + drop self-loops (the rectangular index ranges
    # overlap, so raw symmetrization yields 6 duplicate pairs and 4 loops
    # that make multiset-vs-set comparisons ambiguous downstream)
    keep = row != col
    keys = np.unique(row[keep] * n + col[keep])
    return COO.new(
        (keys // n).astype(np.int32), (keys % n).astype(np.int32), None,
        shape=(n, n),
    ).convert(CSR)


def run(device: bool = False):
    import jax

    if not device:
        jax.config.update("jax_platforms", "cpu")
    from .bases import ReorderBase
    from .convert import coo_to_csr, csr_to_coo, csr_to_csc
    from .formats.csr import CSR
    from .ops.feature import Bandwidth, Degrees, Profile
    from .ops.partition import MetisPartition, balance_ratio, edge_cut
    from .ops.reorder import (
        AMDReorder,
        BOBAReorder,
        DegreeReorder,
        GrayReorder,
        MetisReorder,
        RabbitReorder,
        RCMReorder,
        SlashburnReorder,
    )

    results = {}
    matrices = {
        "ash958(sym)": ash958_graph(),
        "rand-20k": synthetic_graph(20_000, 8),
        "mesh-90k(scrambled)": mesh_graph(300),
    }
    for name, g in matrices.items():
        if device:
            g = g.to_device()
        entry = {"n": g.nrows, "nnz": g.nnz}
        # conversions
        dt = _timeit(lambda c: csr_to_csc(coo_to_csr(csr_to_coo(c))), g)
        entry["convert_roundtrip_nnz_per_s"] = round(g.nnz / dt, 1)
        # reorders: quality on host metrics
        bw0 = int(np.asarray(Bandwidth().get_bandwidth(g)))
        pr0 = int(np.asarray(Profile().get_profile(g)))
        entry["natural"] = {"bandwidth": bw0, "profile": pr0}
        reorders = {
            "degree": DegreeReorder(),
            "rcm": RCMReorder(),
            "gray": GrayReorder(),
            "boba": BOBAReorder(),
            "nested_dissection": MetisReorder(seed=0),
            "rabbit": RabbitReorder(),
            "slashburn": SlashburnReorder(k_size=32),
        }
        if g.nrows <= 5_000:
            # the quotient-graph minimum degree is sequential host code;
            # keep it off large suite matrices
            reorders["amd"] = AMDReorder()
        # fill metric (symbolic nnz(L)) — AMD's acceptance axis
        # (BASELINE.md fill row). The native elimination-tree walker runs
        # rand-20k in ~0.4 s (VERDICT r3 cheap sweep), so only the pure-
        # Python fallback keeps the small-matrix gate.
        from . import native
        from .ops.feature import FillIn

        do_fill = g.nrows <= 5_000 or (
            native.available() and hasattr(native, "fill_in")
        )
        if do_fill:
            entry["natural"]["fill"] = int(FillIn().get_fill(g))
        entry["reorder"] = {}
        for rname, op in reorders.items():
            t0 = time.perf_counter()
            order = op.get_reorder(g)
            dt = time.perf_counter() - t0
            perm = ReorderBase.permute2d(order, g)
            entry["reorder"][rname] = {
                "seconds": round(dt, 3),
                "bandwidth": int(np.asarray(Bandwidth().get_bandwidth(perm))),
                "profile": int(np.asarray(Profile().get_profile(perm))),
            }
            if do_fill:
                entry["reorder"][rname]["fill"] = int(FillIn().get_fill(perm))
        # partition quality
        entry["partition"] = {}
        rng = np.random.default_rng(0)
        for k in (2, 8):
            part = MetisPartition(num_partitions=k, seed=0).partition(g)
            rand = rng.integers(0, k, g.nrows).astype(np.int32)
            entry["partition"][f"k{k}"] = {
                "edge_cut": edge_cut(g, part),
                "random_cut": edge_cut(g, rand),
                "balance": round(balance_ratio(part, k), 3),
            }
        # hypergraph (column-net) quality: connectivity-1, the PaToH
        # objective (anchored in round 4 — tests/test_partition.py)
        from .ops.partition.hypergraph import (
            PatohPartition,
            column_net_hypergraph,
            cutsize_connectivity,
        )

        if g.nrows > 50_000:
            # the exact-gain FM hypergraph refiner is host Python;
            # anchored quality lives on the smaller suite matrices
            results[name] = entry
            continue
        ni, pins, cw = column_net_hypergraph(g)
        k = 4
        t0 = time.perf_counter()
        hp = np.asarray(PatohPartition(num_partitions=k).partition(g))
        wsizes = np.bincount(hp, weights=cw, minlength=k)
        entry["hypergraph_k4"] = {
            "seconds": round(time.perf_counter() - t0, 3),
            "connectivity_minus_1": int(cutsize_connectivity(ni, pins, hp, k)),
            "random": int(
                cutsize_connectivity(
                    ni, pins, rng.integers(0, k, g.nrows).astype(np.int32), k
                )
            ),
            # PaToH balances cell WEIGHT (= degrees), not vertex count
            "balance": round(float(wsizes.max() / (cw.sum() / k)), 3),
        }
        results[name] = entry
    return results


def run_distributed():
    """Distributed reorder/partition quality vs the host algorithms
    (VERDICT round-1 item 6: distributed-RCM bandwidth reduction in the
    suite). Needs ≥2 JAX devices — run under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on CPU, or on
    a real mesh."""
    import jax

    if len(jax.devices()) < 2:
        return {"skipped": "needs >=2 devices (set xla_force_host_platform_device_count)"}

    from .bases import ReorderBase
    from .ops.feature import Bandwidth, Profile
    from .ops.partition import edge_cut as host_edge_cut
    from .ops.reorder import RCMReorder
    from .parallel import ShardedCSR, dist, halo, make_mesh

    mesh = make_mesh(len(jax.devices()))
    out = {"devices": len(jax.devices())}
    matrices = {
        "ash958(sym)": ash958_graph(),
        "rand-20k": synthetic_graph(20_000, 8),
    }
    for name, g in matrices.items():
        sh = ShardedCSR.from_csr(g, mesh, halo=True)
        bw0 = int(np.asarray(Bandwidth().get_bandwidth(g)))
        pr0 = int(np.asarray(Profile().get_profile(g)))
        entry = {
            "n": g.nrows,
            "nnz": g.nnz,
            "natural": {"bandwidth": bw0, "profile": pr0},
            "halo_comm_bytes_per_step": halo.step_comm_bytes(sh),
            "dense_psum_bytes_per_step": 4 * g.nrows * sh.n_shards,
        }

        def quality(order):
            perm = ReorderBase.permute2d(np.asarray(order), g)
            return {
                "bandwidth": int(np.asarray(Bandwidth().get_bandwidth(perm))),
                "profile": int(np.asarray(Profile().get_profile(perm))),
            }

        t0 = time.perf_counter()
        host_order = RCMReorder().get_reorder(g)
        t_host = time.perf_counter() - t0
        entry["rcm_host"] = {"seconds": round(t_host, 3), **quality(host_order)}

        t0 = time.perf_counter()
        d_order = halo.rcm_reorder(sh, mesh)
        jax.block_until_ready(d_order)
        t_dist = time.perf_counter() - t0
        entry["rcm_distributed"] = {"seconds": round(t_dist, 3), **quality(d_order)}

        labels = halo.label_prop_partition(sh, 4, mesh, num_iters=20)
        refined = dist.refine_partition(sh, labels, 4, mesh, rounds=8)
        entry["labelprop_distributed_k4"] = {
            "edge_cut": int(np.asarray(dist.edge_cut(sh, labels, mesh))),
            "edge_cut_refined": int(np.asarray(dist.edge_cut(sh, refined, mesh))),
            "total_nnz": g.nnz,
        }

        # distributed SlashBurn: exact host-order parity (non-greedy)
        from .ops.reorder.slashburn import SlashburnReorderParams, _slashburn_host

        t0 = time.perf_counter()
        sb_dist = np.asarray(halo.slashburn_reorder(sh, mesh, k_size=32))
        t_sb = time.perf_counter() - t0
        sb_host = np.asarray(
            _slashburn_host(g, SlashburnReorderParams(k_size=32, greedy=False))
        )
        entry["slashburn_distributed_k32"] = {
            "seconds": round(t_sb, 3),
            "exact_host_parity": bool(np.array_equal(sb_dist, sb_host)),
        }

        # ring matmul kernels: exact vs host (skip the 20k dense tile on CPU)
        if g.nrows <= 2048:
            from .ops.feature.jaccard import _jaccard_host
            from .ops.feature.triangles import _undirected_count
            from .parallel import ring

            tri = ring.triangle_count(sh, mesh)
            jac = ring.jaccard_flat(sh, mesh)
            entry["ring_mxu"] = {
                "triangles": tri,
                "triangles_match_host": bool(tri == _undirected_count(g)),
                "jaccard_match_host": bool(
                    np.allclose(jac, _jaccard_host(g), atol=1e-6)
                ),
            }
        out[name] = entry
    return out


def to_markdown(results) -> str:
    lines = ["# Benchmark suite results", ""]
    for mname, e in results.items():
        lines += [f"## {mname} — n={e['n']}, nnz={e['nnz']}", ""]
        has_fill = "fill" in e["natural"]
        fill_hdr = " fill |" if has_fill else ""
        lines += [
            f"conversion round trip: {e['convert_roundtrip_nnz_per_s']:.3g} nnz/s",
            "",
            f"| reorder | seconds | bandwidth | profile |{fill_hdr}",
            "|---|---|---|---|" + ("---|" if has_fill else ""),
            f"| (natural) | — | {e['natural']['bandwidth']} | {e['natural']['profile']} |"
            + (f" {e['natural']['fill']} |" if has_fill else ""),
        ]
        for rname, r in e["reorder"].items():
            lines.append(
                f"| {rname} | {r['seconds']} | {r['bandwidth']} | {r['profile']} |"
                + (f" {r.get('fill', '—')} |" if has_fill else "")
            )
        lines += ["", "| k | edge cut | random cut | balance |", "|---|---|---|---|"]
        for kname, p in e["partition"].items():
            lines.append(
                f"| {kname[1:]} | {p['edge_cut']} | {p['random_cut']} | {p['balance']} |"
            )
        if "hypergraph_k4" in e:
            h = e["hypergraph_k4"]
            lines += [
                "",
                "| hypergraph k=4 | λ−1 | random λ−1 | balance |",
                "|---|---|---|---|",
                f"| column-net | {h['connectivity_minus_1']} | {h['random']} | {h['balance']} |",
            ]
        lines.append("")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--out", default=None, help="write a markdown report here")
    ap.add_argument("--json", action="store_true", help="print JSON instead")
    ap.add_argument(
        "--dist",
        action="store_true",
        help="distributed quality table only (needs >=2 devices)",
    )
    args = ap.parse_args()
    if args.dist:
        import jax

        if not args.device:
            jax.config.update("jax_platforms", "cpu")
        print(json.dumps(run_distributed(), indent=2))
        return
    results = run(device=args.device)
    if args.json:
        print(json.dumps(results, indent=2))
    else:
        md = to_markdown(results)
        if args.out:
            with open(args.out, "w") as f:
                f.write(md)
            print(f"wrote {args.out}")
        else:
            print(md)


if __name__ == "__main__":
    main()
