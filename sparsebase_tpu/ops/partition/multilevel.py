"""Native multilevel k-way graph partitioning (METIS-equivalent).

JAX-native analogue of ``partition::MetisPartition``
(reference: src/sparsebase/partition/metis_partition.cc:33-90, wrapping
external METIS ``METIS_PartGraphKway``/``Recursive``; 17-field params
metis_partition.h:17-37). The reference delegates to a vendored solver;
here the multilevel scheme is implemented natively (this also supplies
the "coarsening" capability the reference lists in its vision but never
implements — SURVEY.md §2.6 note):

* **coarsening** — randomized heavy-edge matching: every vertex proposes
  to its heaviest unmatched neighbor, reciprocated proposals contract;
  a few vectorized rounds per level (no sequential visit order)
* **initial partition** — weighted BFS region growing from k spread
  seeds on the coarsest graph, then balance fixup
* **uncoarsening** — project labels and refine at every level with
  weighted boundary label propagation under a vertex-weight capacity +
  greedy eviction (FM-flavoured, move-all-positive-gain rounds)

Quality is judged on edge-cut parity (BASELINE.md): tests gate the cut
against known-structure graphs and random baselines.

Host-side numpy (preprocessing path, like the reference's). ``ptype``
selects kway (direct) or rb (recursive bisection).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ...formats.csr import CSR
from ...utils.exceptions import PartitionError
from .base import Partitioner


@dataclasses.dataclass
class MetisPartitionParams:
    """Field-parity with MetisPartitionParams (metis_partition.h:17-37);
    options without a native equivalent are accepted and ignored."""

    num_partitions: int = 2
    ptype: str = "kway"  # "kway" | "rb"
    objtype: str = "cut"  # "cut" | "vol" (vol treated as cut natively)
    ctype: str = "shem"  # coarsening: heavy-edge matching
    rtype: str = "fm"
    nseps: int = 1
    niter: int = 10
    ncuts: int = 1
    seed: int = 42
    minconn: int = 0
    no2hop: int = 0
    contig: int = 0
    compress: int = 0
    ccorder: int = 0
    pfactor: int = 0
    ufactor: int = 30  # allowed imbalance = 1 + ufactor/1000
    numbering: int = 0


# ---------------------------------------------------------------------------
# graph helpers (weighted CSR as plain arrays)
# ---------------------------------------------------------------------------


def _symmetrize(indptr, indices, ewts, n):
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ur = np.concatenate([row, indices])
    uc = np.concatenate([indices, row])
    uw = np.concatenate([ewts, ewts])
    keep = ur != uc
    ur, uc, uw = ur[keep], uc[keep], uw[keep]
    key = ur * n + uc
    order = np.argsort(key, kind="stable")
    key_s, uw_s = key[order], uw[order]
    uniq_mask = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    uniq_keys = key_s[uniq_mask]
    seg = np.cumsum(uniq_mask) - 1
    w = np.zeros(len(uniq_keys), uw.dtype)
    np.add.at(w, seg, uw_s)
    r = (uniq_keys // n).astype(np.int64)
    c = (uniq_keys % n).astype(np.int64)
    ip = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))]).astype(np.int64)
    return ip, c, w


def _heavy_edge_matching(indptr, indices, ewts, vwts, rng, max_vwt):
    """match[v] = partner (or v). Reciprocal-proposal randomized HEM."""
    n = len(indptr) - 1
    match = np.full(n, -1, np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for _round in range(4):
        unmatched = match < 0
        if not unmatched.any():
            break
        # candidate edges: both endpoints unmatched, contracted weight cap
        ok = unmatched[row] & unmatched[indices] & (vwts[row] + vwts[indices] <= max_vwt)
        if not ok.any():
            break
        # propose to heaviest eligible neighbor (tie-break random via jitter)
        jitter = rng.random(len(ewts)) * 0.01
        score = np.where(ok, ewts + jitter, -np.inf)
        best = np.full(n, -1, np.int64)
        best_score = np.full(n, -np.inf)
        np.maximum.at(best_score, row, score)
        # recover argmax per row
        is_best = score >= best_score[row] - 1e-12
        cand = np.where(ok & is_best)[0]
        best[row[cand]] = indices[cand]
        # reciprocal matches
        has = best >= 0
        v = np.nonzero(has)[0]
        partner = best[v]
        recip = best[partner] == v
        a, b = v[recip], partner[recip]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        match[lo] = hi
        match[hi] = lo
    match[match < 0] = np.nonzero(match < 0)[0]
    return match


def _contract(indptr, indices, ewts, vwts, match):
    n = len(indptr) - 1
    # coarse id: one per match pair (lo representative)
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    cvwts = np.zeros(nc, vwts.dtype)
    np.add.at(cvwts, cmap, vwts)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cr, cc = cmap[row], cmap[indices]
    keep = cr != cc
    cr, cc, w = cr[keep], cc[keep], ewts[keep]
    key = cr * nc + cc
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], w[order]
    if len(key_s):
        uniq_mask = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        seg = np.cumsum(uniq_mask) - 1
        uniq_keys = key_s[uniq_mask]
        cw = np.zeros(len(uniq_keys), w.dtype)
        np.add.at(cw, seg, w_s)
    else:
        uniq_keys = key_s
        cw = np.zeros(0, w.dtype)
    r2 = (uniq_keys // nc).astype(np.int64)
    c2 = (uniq_keys % nc).astype(np.int64)
    ip = np.concatenate([[0], np.cumsum(np.bincount(r2, minlength=nc))]).astype(np.int64)
    return ip, c2, cw, cvwts, cmap


def _region_grow(indptr, indices, ewts, vwts, k, rng, cap):
    """Initial partition on the coarsest graph: weighted BFS growing."""
    n = len(indptr) - 1
    labels = np.full(n, -1, np.int64)
    sizes = np.zeros(k, np.float64)
    seeds = rng.choice(n, size=min(k, n), replace=False)
    frontier = [list() for _ in range(k)]
    for p, s in enumerate(seeds):
        labels[s] = p
        sizes[p] += vwts[s]
        frontier[p].extend(indices[indptr[s] : indptr[s + 1]].tolist())
    # round-robin growth from the lightest part
    import heapq

    heap = [(sizes[p], p) for p in range(k)]
    heapq.heapify(heap)
    stall = 0
    while (labels < 0).any() and stall < 2 * k:
        _, p = heapq.heappop(heap)
        grew = False
        while frontier[p]:
            v = frontier[p].pop()
            if labels[v] < 0:
                labels[v] = p
                sizes[p] += vwts[v]
                frontier[p].extend(indices[indptr[v] : indptr[v + 1]].tolist())
                grew = True
                break
        if not grew:
            stall += 1
        else:
            stall = 0
        heapq.heappush(heap, (sizes[p], p))
    # unreached: assign to lightest part
    for v in np.nonzero(labels < 0)[0]:
        p = int(np.argmin(sizes))
        labels[v] = p
        sizes[p] += vwts[v]
    return labels


def _refine(indptr, indices, ewts, vwts, labels, k, cap, rounds=8, rng=None):
    """Weighted boundary refinement (FM-flavoured, vectorized): positive
    gains always; zero-gain moves toward a smaller part or by coin flip
    (boundary straightening / plateau escape — positive-only refinement
    measurably stalls at 2-3x cuts on grids); best labeling kept."""
    n = len(indptr) - 1
    rng = rng or np.random.default_rng(0x9E3779B9)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    def cut(lab):
        return float(ewts[lab[row] != lab[indices]].sum())

    best_lab = labels.copy()
    best_cut = cut(labels)
    for _ in range(rounds * 3):
        aff = np.zeros((n, k), np.float64)
        np.add.at(aff, (row, labels[indices]), ewts)
        sizes = np.zeros(k, np.float64)
        np.add.at(sizes, labels, vwts)
        cur = aff[np.arange(n), labels]
        # forbid moves into full parts
        full = sizes + 0.0 >= cap
        aff_masked = aff.copy()
        aff_masked[:, full] = -np.inf
        aff_masked[np.arange(n), labels] = -np.inf
        best = np.argmax(aff_masked, axis=1)
        gain = aff_masked[np.arange(n), best] - cur
        zero_ok = (gain == 0) & (
            (sizes[best] + vwts < sizes[labels]) | (rng.random(n) < 0.3)
        )
        movers = np.nonzero((gain > 0) | zero_ok)[0]
        if movers.size == 0:
            break
        # accept in gain order, updating sizes (sequential but only movers)
        moved = 0
        for v in movers[np.argsort(-gain[movers])]:
            tgt = int(best[v])
            if sizes[tgt] + vwts[v] <= cap and labels[v] != tgt:
                sizes[labels[v]] -= vwts[v]
                sizes[tgt] += vwts[v]
                labels[v] = tgt
                moved += 1
        c = cut(labels)
        if c < best_cut:
            best_cut = c
            best_lab = labels.copy()
        if moved == 0:
            break
    return best_lab


def multilevel_partition(csr: CSR, params: MetisPartitionParams) -> np.ndarray:
    csr = csr.to_host()
    n = csr.nrows
    k = int(params.num_partitions)
    if k <= 1:
        return np.zeros(n, np.int32)
    if params.ptype == "kway":
        from ... import native

        if native.available():
            ew = (
                np.abs(np.asarray(csr.vals)).astype(np.float64)
                if csr.vals is not None
                else None
            )
            return native.partition_kway(
                n,
                np.asarray(csr.indptr),
                np.asarray(csr.indices),
                ew,
                k,
                params.seed,
                params.ufactor,
                params.niter,
            ).astype(np.int32)
    indptr = np.asarray(csr.indptr).astype(np.int64)
    indices = np.asarray(csr.indices).astype(np.int64)
    ewts = (
        np.abs(np.asarray(csr.vals)).astype(np.float64)
        if csr.vals is not None
        else np.ones(csr.nnz, np.float64)
    )
    indptr, indices, ewts = _symmetrize(indptr, indices, ewts, n)
    vwts = np.ones(n, np.float64)
    rng = np.random.default_rng(params.seed)
    total_w = float(vwts.sum())
    cap = (1.0 + params.ufactor / 1000.0) * total_w / k

    def ladder(coarsest):
        graphs = [(indptr, indices, ewts, vwts)]
        cmaps = []
        while len(graphs[-1][0]) - 1 > coarsest:
            ip, ix, ew, vw = graphs[-1]
            nv = len(ip) - 1
            match = _heavy_edge_matching(
                ip, ix, ew, vw, rng, max_vwt=4.0 * total_w / max(nv, 1)
            )
            nip, nix, new, nvw, cmap = _contract(ip, ix, ew, vw, match)
            if len(nip) - 1 >= nv * 0.95:
                break
            graphs.append((nip, nix, new, nvw))
            cmaps.append(cmap)

        ip, ix, ew, vw = graphs[-1]
        if params.ptype == "rb" and k > 2:
            labels = _recursive_bisection(ip, ix, ew, vw, k, rng, params.ufactor)
        else:
            labels = _region_grow(ip, ix, ew, vw, k, rng, cap)
        labels = _refine(ip, ix, ew, vw, labels, k, cap, rounds=params.niter)
        for level in range(len(cmaps) - 1, -1, -1):
            labels = labels[cmaps[level]]
            ip, ix, ew, vw = graphs[level]
            labels = _refine(ip, ix, ew, vw, labels, k, cap,
                             rounds=max(params.niter // 2, 2))
        return labels

    def cut_of(lab):
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        return float(ewts[lab[row] != lab[indices]].sum())

    # two ladder depths (shallow preserves geometry at small k; deep gives
    # the initial partition a tiny coarsest graph at large k), best cut
    # kept — same scheme as the native kway_core.
    best_lab, best_cut = None, None
    for coarsest in {max(20 * k, 128), max(4 * k, 48)}:
        lab = ladder(coarsest)
        c = cut_of(lab)
        if best_cut is None or c < best_cut:
            best_lab, best_cut = lab, c
    return best_lab.astype(np.int32)


def _recursive_bisection(ip, ix, ew, vw, k, rng, ufactor):
    """k-way by recursive 2-way splits (METIS_PartGraphRecursive analogue)."""
    n = len(ip) - 1
    labels = np.zeros(n, np.int64)

    def split(vertices, parts_lo, parts_hi):
        if parts_hi - parts_lo <= 1 or len(vertices) == 0:
            labels[vertices] = parts_lo
            return
        # build subgraph
        sub_id = np.full(n, -1, np.int64)
        sub_id[vertices] = np.arange(len(vertices))
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        emask = (sub_id[row] >= 0) & (sub_id[ix] >= 0)
        sr, sc, sw = sub_id[row[emask]], sub_id[ix[emask]], ew[emask]
        sip = np.concatenate([[0], np.cumsum(np.bincount(sr, minlength=len(vertices)))]).astype(np.int64)
        order = np.argsort(sr, kind="stable")
        six, sew = sc[order], sw[order]
        svw = vw[vertices]
        mid = (parts_hi - parts_lo) // 2
        frac_cap = (1.0 + ufactor / 1000.0) * svw.sum() / 2
        two = _region_grow(sip, six, sew, svw, 2, rng, frac_cap)
        two = _refine(sip, six, sew, svw, two, 2, frac_cap)
        left = vertices[two == 0]
        right = vertices[two == 1]
        split(left, parts_lo, parts_lo + mid)
        split(right, parts_lo + mid, parts_hi)

    split(np.arange(n), 0, k)
    return labels


class MetisPartition(Partitioner):
    """Native multilevel k-way partitioner (METIS-equivalent API)."""

    def __init__(self, **kw):
        super().__init__("metis_partition")
        self.params = MetisPartitionParams(**kw)
        self.register((CSR,), lambda f, p: multilevel_partition(f[0], p))
