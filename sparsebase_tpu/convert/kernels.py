"""Format-conversion kernels (dual backend: numpy on host, XLA on device).

JAX-native redesign of the reference conversion functions
(reference: src/sparsebase/converter/converter_order_two.cc — COO→CSR
counting + prefix-sum :163-214, CSR→COO row expansion :72-118, COO→CSC
column counting :21-70, CSR→CSC composite :120-128). Differences:

* Sort-based formulations replace sequential counting loops: histogram =
  ``bincount`` + ``cumsum``; row expansion = vectorized ``searchsorted``;
  (col, row) reorder = stable key-sort. All are single XLA ops that map
  onto vectorized sorts and elementwise passes — no scalar loops.
* CSC is a **full node**: CSC→COO/CSR edges exist (the reference leaves
  CSC a sink, SURVEY.md §2.3).
* Move-vs-copy distinction is unnecessary (immutable arrays).

Every kernel is pure and jit-compatible (static shapes from the pytree
metadata), so whole pipelines containing conversions fuse under one jit.
"""

from __future__ import annotations

import numpy as np

from ..formats.array import DenseArray
from ..formats.base import xp_for
from ..formats.coo import COO
from ..formats.csc import CSC
from ..formats.csr import CSR


def _bincount(xp, x, length, dtype):
    if xp is np:
        return np.bincount(x, minlength=length).astype(dtype)[:length]
    import jax.numpy as jnp

    return jnp.bincount(x, length=length).astype(dtype)


def _indptr_from_counts(xp, counts, nnz_dtype):
    zero = xp.zeros((1,), dtype=nnz_dtype)
    return xp.concatenate([zero, xp.cumsum(counts).astype(nnz_dtype)])


def indptr_from_sorted_rows(row, nrows: int, nnz: int):
    """CSR ``indptr`` from a row-major-sorted COO row array — device kernel.

    In place of the histogram formulation (``bincount`` = scatter-add),
    this boundary formulation costs one unstable 1-key sort plus O(n)
    work:

    1. mark run heads (``row[k] != row[k-1]``) — each real row id appears
       exactly once among the heads, already in ascending row order;
    2. sort ``(key, position)`` where ``key = row`` at heads and ``nrows``
       (a dummy that sorts last) elsewhere — this *compacts* the ≤ nrows
       head positions to the front without a dynamic-shape mask;
    3. scatter the head positions into a dense ``(nrows+1,)`` array
       initialised to ``nnz`` and close gaps (empty rows) with a reverse
       ``cummin``.

    Parity: the sequential counting loop of CooCsrFunctionConditional
    (reference: src/sparsebase/converter/converter_order_two.cc:163-214).
    """
    import jax
    import jax.numpy as jnp

    dt = row.dtype
    pos = jnp.arange(nnz, dtype=dt)
    prev = jnp.concatenate([jnp.full((1,), -1, dt), row[:-1]])
    key = jnp.where(row != prev, row, jnp.asarray(nrows, dt))
    skey, spos = jax.lax.sort((key, pos), num_keys=1, is_stable=False)
    m = min(nrows, nnz)
    # dummies (key == nrows) land in the sentinel slot and are overwritten
    starts = (
        jnp.full((nrows + 1,), nnz, dt)
        .at[skey[:m]]
        .set(spos[:m], mode="drop")
        .at[nrows]
        .set(jnp.asarray(nnz, dt))
    )
    # empty rows inherit the next non-empty row's start
    return jax.lax.cummin(starts, reverse=True)


def indptr_from_sorted_rows_blocked(row, nrows: int, nnz: int, block: int = 512):
    """CSR ``indptr`` from row-major-sorted rows — blocked-compaction
    formulation of :func:`indptr_from_sorted_rows`.

    In place of one global 1-key boundary sort, per-row ``lax.sort`` over
    a (B, K) reshape: run heads are sorted to the *front of each K-block*
    instead of globally, then compacted with O(n) work:

    1. mark run heads, key = row at heads else ``nrows`` (sorts last);
    2. reshape to (B, K) (pad with sentinels) and sort each block's
       (key, global position) — heads now occupy each block's prefix;
    3. per-block head counts → exclusive prefix ``Hpre``; for each
       compact slot t < total heads, its (block, offset) is recovered
       with the delta-scatter + cumsum trick (no searchsorted), and the
       (key, pos) pair is fetched with two n-sized gathers;
    4. scatter head positions into ``starts`` and close empty-row gaps
       with a reverse ``cummin`` (same tail as the global kernel).

    Identical output to :func:`indptr_from_sorted_rows` (fuzz-tested);
    parity: src/sparsebase/converter/converter_order_two.cc:163-214.
    """
    import jax
    import jax.numpy as jnp

    dt = row.dtype
    if nnz == 0:
        return jnp.zeros((nrows + 1,), dt)
    K = int(block)
    B = -(-nnz // K)
    P = B * K
    sent = jnp.asarray(nrows, jnp.int32)
    r32 = row.astype(jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), r32[:-1]])
    key = jnp.where(r32 != prev, r32, sent)
    if P != nnz:
        key = jnp.concatenate([key, jnp.full((P - nnz,), sent, jnp.int32)])
    kb = key.reshape(B, K)
    pos = jnp.arange(P, dtype=jnp.int32).reshape(B, K)
    ks, ps = jax.lax.sort((kb, pos), dimension=1, num_keys=1, is_stable=False)
    h = (ks != sent).sum(axis=1).astype(jnp.int32)
    Hpre = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(h).astype(jnp.int32)]
    )
    ncap = min(nrows, nnz)  # total heads <= min(nrows, nnz)
    t = jnp.arange(ncap, dtype=jnp.int32)
    # block id b(t) and Hpre[b(t)] are piecewise constant over compact
    # slots: scatter deltas at each block's first compact slot + cumsum
    bstarts = Hpre[1:-1]  # first compact slot of blocks 1..B-1
    b = jnp.cumsum(jnp.zeros((ncap,), jnp.int32).at[bstarts].add(1, mode="drop"))
    hpre_t = jnp.cumsum(
        jnp.zeros((ncap,), jnp.int32).at[bstarts].add(h[:-1], mode="drop")
    )
    flat = b * K + (t - hpre_t)
    keyc = ks.reshape(-1)[flat]
    posc = ps.reshape(-1)[flat]
    keyc = jnp.where(t < Hpre[-1], keyc, sent)
    starts = (
        jnp.full((nrows + 1,), nnz, dt)
        .at[keyc]
        .set(posc.astype(dt), mode="drop")
        .at[nrows]
        .set(jnp.asarray(nnz, dt))
    )
    return jax.lax.cummin(starts, reverse=True)


def expand_row_table(table, indptr, nnz: int, out_dtype=None):
    """``out[k] = table[r(k)]`` for integer ``table`` over CSR row blocks —
    without an nnz-sized random gather: the value is piecewise constant
    over the contiguous row blocks, so scatter per-row deltas at the row
    starts and prefix-sum. Empty rows stack
    their deltas on one slot (the add telescopes); trailing empty rows
    scatter out of bounds and are dropped. Integer tables only (float
    deltas would accumulate rounding)."""
    import jax.numpy as jnp

    out_dtype = out_dtype or table.dtype
    t = table.astype(jnp.int32)
    deltas = jnp.concatenate([t[:1], t[1:] - t[:-1]])
    return jnp.cumsum(
        jnp.zeros((max(nnz, 1),), jnp.int32).at[indptr[:-1]].add(deltas, mode="drop")
    )[:nnz].astype(out_dtype)


def coo_to_csr(coo: COO) -> CSR:
    """COO→CSR relying on the row-major sort invariant
    (parity: CooCsrFunctionConditional, converter_order_two.cc:163-214).
    Host: histogram + prefix sum. Device: sorted-runs boundary kernel
    (:func:`indptr_from_sorted_rows_blocked`) instead of a scatter-add
    histogram."""
    xp = xp_for(coo.row, coo.col)
    nnz_dtype = coo.row.dtype
    if xp is np:
        counts = _bincount(xp, coo.row, coo.nrows, nnz_dtype)
        indptr = _indptr_from_counts(xp, counts, nnz_dtype)
    else:
        indptr = indptr_from_sorted_rows_blocked(coo.row, coo.nrows, coo.nnz)
    return CSR(indptr, coo.col, coo.vals, coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    """Row expansion via vectorized searchsorted
    (parity: CsrCooFunctionConditional, converter_order_two.cc:72-118)."""
    row = csr.row_of_nnz()
    return COO(row, csr.indices, csr.vals, csr.shape)


def lexsort_pairs(xp, major, minor):
    """Permutation sorting entries by (major, minor), via two stable sorts.

    Avoids wide int64 fused keys (``major * extent + minor`` overflows int32
    for matrices with > 2^31 cells, and jax without x64 silently truncates).
    Prefer :func:`sort_by_pairs` on device — it fuses the two keys and the
    payload into one ``lax.sort`` call.
    """
    order1 = xp.argsort(minor, stable=True)
    order2 = xp.argsort(major[order1], stable=True)
    return order1[order2]


def sort_by_pairs(xp, major, minor, *payload, stable_payload: bool = True):
    """Sort entries by (major, minor), carrying payload arrays along.

    Returns ``(major_sorted, minor_sorted, *payload_sorted)``. Device path
    is a single variadic ``jax.lax.sort`` with ``num_keys=2`` — one fused
    sort instead of two stable argsorts plus per-array gathers (the
    argsort formulation). ``None`` payload entries
    pass through as ``None``.

    ``stable_payload=False`` permits unstable payload order among
    duplicate (major, minor) coordinates — callers with accumulation
    semantics (readers) use it to unlock the native struct-sort fast
    path for weighted entries (no index argsort, no apply-gathers).
    """
    live = [p for p in payload if p is not None]
    if xp is np:
        if (
            not stable_payload
            and len(live) == 1
            and len(major) >= 1 << 16
            and np.issubdtype(np.asarray(live[0]).dtype, np.floating)
        ):
            try:
                from ..io import fastio

                res = fastio.sort_pairs_weighted_inplace(
                    np.asarray(major), np.asarray(minor), np.asarray(live[0])
                )
            except Exception:
                res = None
            if res is not None:
                mj, mn, vv = res
                out = [
                    mj.astype(major.dtype, copy=False),
                    mn.astype(minor.dtype, copy=False),
                ]
                result2 = []
                for p in payload:
                    if p is None:
                        result2.append(None)
                    else:
                        result2.append(vv.astype(np.asarray(p).dtype, copy=False))
                return tuple(out + result2)
        if not live and len(major) >= 1 << 16:
            # pattern fast path: packed in-place native sort — no index
            # payload, no apply-gathers (~2x argsort at 50M; r4 sweep)
            try:
                from ..io import fastio

                res = fastio.sort_pairs_inplace(np.asarray(major), np.asarray(minor))
            except Exception:
                res = None
            if res is not None:
                mj, mn = res
                outs2 = [mj.astype(major.dtype, copy=False),
                         mn.astype(minor.dtype, copy=False)]
                return tuple(outs2 + [None] * len(payload))
        order = None
        if len(major) >= 1 << 16:  # native parallel sort pays off
            try:
                from ..io import fastio

                order = fastio.argsort_pairs(np.asarray(major), np.asarray(minor))
            except Exception:
                order = None
        if order is None:
            order = np.lexsort((minor, major))
        outs = [major[order], minor[order]] + [p[order] for p in live]
    else:
        import jax

        # not is_stable: ties are exact duplicate (major, minor) pairs whose
        # payload order is unobservable (duplicates accumulate), so the
        # sort need not be stable
        outs = list(jax.lax.sort((major, minor, *live), num_keys=2, is_stable=False))
    result = outs[:2]
    it = iter(outs[2:])
    for p in payload:
        result.append(None if p is None else next(it))
    return tuple(result)


def _order2_transpose_sort(xp, major, minor, vals, n_major, major_extent):
    """Stable sort entries by (major, minor); returns (indptr, minor, vals)."""
    _, minor_sorted, vals_sorted = sort_by_pairs(xp, major, minor, vals)
    counts = _bincount(xp, major, n_major, major.dtype)
    indptr = _indptr_from_counts(xp, counts, major.dtype)
    return indptr, minor_sorted, vals_sorted


def coo_to_csc(coo: COO) -> CSC:
    """Sort by (col, row) then column-histogram
    (parity: CooCscFunctionConditional, converter_order_two.cc:21-70)."""
    xp = xp_for(coo.row, coo.col)
    indptr, rows, vals = _order2_transpose_sort(
        xp, coo.col, coo.row, coo.vals, coo.ncols, coo.nrows
    )
    return CSC(indptr, rows, vals, coo.shape)


def csc_to_coo(csc: CSC) -> COO:
    """CSC → row-major-sorted COO (new edge; CSC is a sink in the reference)."""
    xp = xp_for(csc.indptr, csc.indices)
    col = csc.col_of_nnz()
    row = csc.indices
    row_s, col_s, vals_s = sort_by_pairs(xp, row, col, csc.vals)
    return COO(row_s, col_s, vals_s, csc.shape)


def csr_to_csc(csr: CSR) -> CSC:
    """Direct CSR→CSC transpose-sort (the reference routes CSR→COO→CSC,
    converter_order_two.cc:120-128; one fused sort is cheaper)."""
    xp = xp_for(csr.indptr, csr.indices)
    row = csr.row_of_nnz()
    indptr, rows, vals = _order2_transpose_sort(
        xp, csr.indices, row, csr.vals, csr.ncols, csr.nrows
    )
    return CSC(indptr, rows, vals, csr.shape)


def csr_to_dia(csr: CSR):
    """CSR → DIA (diagonal storage). Present offsets are discovered with
    one scatter + a small host sync (they become static metadata); data
    fills with one scatter-add. Use after bandwidth-reducing reordering —
    storage is O(bandwidth · n)."""
    from ..formats.dia import DIA

    xp = xp_for(csr.indptr, csr.indices)
    n, m = csr.shape
    row = csr.row_of_nnz()
    off = csr.indices.astype(xp.int32) - row.astype(xp.int32)  # in [-(n-1), m-1]
    span = n + m - 1
    if xp is np:
        present = np.zeros(span, bool)
        present[off + (n - 1)] = True
        offsets = (np.nonzero(present)[0] - (n - 1)).astype(np.int32)
        lut = np.zeros(span, np.int32)
        lut[offsets + (n - 1)] = np.arange(len(offsets), dtype=np.int32)
        d_idx = lut[off + (n - 1)]
        vals = csr.vals if csr.vals is not None else np.ones(csr.nnz, np.float32)
        data = np.zeros((len(offsets), n), vals.dtype)
        np.add.at(data, (d_idx, row), vals)
        return DIA(offsets, data, (n, m))
    import jax.numpy as jnp

    present = jnp.zeros((span,), bool).at[off + (n - 1)].set(True)
    offsets_np = (np.nonzero(np.asarray(present))[0] - (n - 1)).astype(np.int32)
    offsets = jnp.asarray(offsets_np)
    lut = jnp.zeros((span,), jnp.int32).at[offsets + (n - 1)].set(
        jnp.arange(len(offsets_np), dtype=jnp.int32)
    )
    d_idx = lut[off + (n - 1)]
    vals = csr.vals if csr.vals is not None else jnp.ones((csr.nnz,), jnp.float32)
    data = jnp.zeros((len(offsets_np), n), vals.dtype).at[d_idx, row].add(vals)
    return DIA(offsets, data, (n, m))


def dia_to_csr(dia) -> CSR:
    """DIA → CSR (host; the stored band is scanned densely)."""
    d = dia.to_host()
    offs = np.asarray(d.offsets)
    data = np.asarray(d.data)
    n, m = d.shape
    rows, cols, vals = [], [], []
    for k, off in enumerate(offs.tolist()):
        i = np.arange(n)
        j = i + off
        ok = (j >= 0) & (j < m) & (data[k] != 0)
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(data[k][ok])
    row = np.concatenate(rows) if rows else np.zeros(0, np.int32)
    col = np.concatenate(cols) if cols else np.zeros(0, np.int32)
    val = np.concatenate(vals) if vals else np.zeros(0, data.dtype)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int64)
    return CSR(indptr, col.astype(np.int32), val, (n, m))


def csc_to_csr(csc: CSC) -> CSR:
    """Direct CSC→CSR transpose-sort (new edge)."""
    xp = xp_for(csc.indptr, csc.indices)
    col = csc.col_of_nnz()
    indptr, cols, vals = _order2_transpose_sort(
        xp, csc.indices, col, csc.vals, csc.nrows, csc.ncols
    )
    return CSR(indptr, cols, vals, csc.shape)


def csr_to_ell(csr: CSR, width=None):
    """CSR → ELL (row-padded). Entry costs one nnz-sized scatter; once
    there, row permutation is a 2-D row gather and column sorts are
    per-row. ``width`` defaults to the max
    row degree (a small host sync — it becomes static metadata)."""
    from ..formats.ell import ELL

    xp = xp_for(csr.indptr, csr.indices)
    n, m = csr.shape
    deg = csr.indptr[1:] - csr.indptr[:-1]
    if width is None:
        width = int(np.asarray(deg.max() if xp is np else deg.max()))
    width = max(int(width), 1)
    row = csr.row_of_nnz()
    if xp is np:
        if int(deg.max(initial=0)) > width:
            raise ValueError(f"csr_to_ell: width {width} < max degree")
        pos = np.arange(csr.nnz) - np.asarray(csr.indptr)[np.asarray(row)]
        cols = np.zeros((n, width), np.int32)
        cols[np.asarray(row), pos] = np.asarray(csr.indices)
        vals = None
        if csr.vals is not None:
            vals = np.zeros((n, width), csr.vals.dtype)
            vals[np.asarray(row), pos] = np.asarray(csr.vals)
        return ELL(cols, vals, np.asarray(deg).astype(np.int32), (n, m))
    import jax.numpy as jnp

    # Match the numpy path: a caller-supplied width below the max row
    # degree is an error, not silent truncation (lens=deg would overcount
    # nnz and ell_to_csr would index past the row). The check needs a
    # host sync, so it only runs eagerly; under a jit trace (legal when
    # the caller supplies an explicit width — shapes stay static) the
    # caller takes responsibility for width >= max degree.
    import jax

    if n > 0 and not isinstance(deg, jax.core.Tracer):
        if int(np.asarray(deg.max())) > width:
            raise ValueError(f"csr_to_ell: width {width} < max degree")
    pos = jnp.arange(csr.nnz, dtype=jnp.int32) - expand_row_table(
        csr.indptr[:-1], csr.indptr, csr.nnz, out_dtype=jnp.int32
    )
    flat = row.astype(jnp.int32) * width + pos
    cols = (
        jnp.zeros((n * width,), jnp.int32)
        .at[flat]
        .set(csr.indices.astype(jnp.int32), mode="drop")
        .reshape(n, width)
    )
    vals = None
    if csr.vals is not None:
        vals = (
            jnp.zeros((n * width,), csr.vals.dtype)
            .at[flat]
            .set(csr.vals, mode="drop")
            .reshape(n, width)
        )
    return ELL(cols, vals, deg.astype(jnp.int32), (n, m))


def ell_to_csr(ell):
    """ELL → CSR: per-element gather of the valid slots back to flat
    order (row-major; within-row order preserved)."""
    from ..formats.ell import ELL  # noqa: F401

    xp = xp_for(ell.cols, ell.lens)
    n, m = ell.shape
    w = ell.width
    lens = ell.lens
    if xp is np:
        indptr = np.concatenate([[0], np.cumsum(np.asarray(lens))]).astype(np.int64)
        mask = np.asarray(ell.valid_mask())
        indices = np.asarray(ell.cols)[mask]
        vals = None if ell.vals is None else np.asarray(ell.vals)[mask]
        return CSR(indptr, indices.astype(np.int64), vals, (n, m))
    import jax.numpy as jnp

    nnz = ell.nnz  # host sync: flat shapes must be static
    indptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(lens).astype(jnp.int32)]
    )
    row = _flat_row_of(jnp, indptr, nnz)
    pos = jnp.arange(nnz, dtype=jnp.int32) - indptr[row]
    flat = row * w + pos
    indices = ell.cols.reshape(-1)[flat]
    vals = None if ell.vals is None else ell.vals.reshape(-1)[flat]
    return CSR(indptr, indices, vals, (n, m))


def _flat_row_of(jnp, indptr, nnz):
    marks = jnp.zeros((max(nnz, 1),), jnp.int32).at[indptr[:-1]].add(
        1, mode="drop"
    )
    return (jnp.cumsum(marks) - 1)[:nnz]
