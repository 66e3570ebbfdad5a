"""Shared tiny-matrix fixture and property checks.

Port of the reference's global test fixture
(reference: tests/suites/sparsebase/functionality_common.inc:6-56) — the
3x3, nnz=4 matrix

    0 1 2
    3 0 0
    4 0 0

with hand-computed expected results for conversions, permutations,
heatmaps and degree features, plus the property-check helpers
(check_reorder :91-99, check_degree_ordering :67-90, check_partition
:101-107, compare_csr :108-122).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# the reference's ash958, symmetrized to a 958x958 pattern (A ∪ Aᵀ with
# duplicates kept), as committed with the golden parity outputs
ASH958_SYM = str(Path(__file__).parent / "golden" / "ash958_sym.mtx")

N = 3
NNZ = 4

# CSR of the fixture matrix
ROW_PTR = np.array([0, 2, 3, 4], dtype=np.int32)
COLS = np.array([1, 2, 0, 0], dtype=np.int32)
VALS = np.array([1, 2, 3, 4], dtype=np.int32)

# COO (row-major sorted)
ROWS = np.array([0, 0, 1, 2], dtype=np.int32)
COO_COLS = np.array([1, 2, 0, 0], dtype=np.int32)
COO_VALS = np.array([1, 2, 3, 4], dtype=np.int32)

# CSC
COL_PTR = np.array([0, 2, 3, 4], dtype=np.int32)
ROW_IND = np.array([1, 2, 0, 0], dtype=np.int32)
VALS_CSC = np.array([3, 4, 1, 2], dtype=np.int32)

DEGREES = np.array([2, 1, 1], dtype=np.int32)
DISTRIBUTION = np.array([2.0 / NNZ, 1.0 / NNZ, 1.0 / NNZ], dtype=np.float32)

DENSE = np.array([[0, 1, 2], [3, 0, 0], [4, 0, 0]], dtype=np.int32)

HEATMAP_NO_ORDER = np.array(
    [0, 0.25, 0.25, 0.25, 0, 0, 0.25, 0, 0], dtype=np.float32
).reshape(3, 3)

# Row reordering: r_reorder_vector[i] = j -> row i moves to position j
R_REORDER = np.array([1, 2, 0], dtype=np.int32)
R_ROW_PTR = np.array([0, 1, 3, 4], dtype=np.int32)
R_COLS = np.array([0, 1, 2, 0], dtype=np.int32)
R_VALS = np.array([4, 1, 2, 3], dtype=np.int32)

# Column reordering
C_REORDER = np.array([2, 0, 1], dtype=np.int32)
C_ROW_PTR = np.array([0, 2, 3, 4], dtype=np.int32)
C_COLS = np.array([0, 1, 2, 2], dtype=np.int32)
C_VALS = np.array([1, 2, 3, 4], dtype=np.int32)

# Row+column reordering
RC_ROW_PTR = np.array([0, 1, 3, 4], dtype=np.int32)
RC_COLS = np.array([2, 0, 1, 2], dtype=np.int32)
RC_VALS = np.array([4, 1, 2, 3], dtype=np.int32)
HEATMAP_RC_ORDER = np.array(
    [0, 0, 0.25, 0.25, 0.25, 0, 0, 0, 0.25], dtype=np.float32
).reshape(3, 3)

# Order-1 array permutation fixture
INV_PERM_ARRAY = np.array([2, 0, 1], dtype=np.int32)
PERM_ARRAY = np.array([1, 2, 0], dtype=np.int32)
ORIGINAL_ARRAY = np.array([0.0, 0.1, 0.2], dtype=np.float32)
REORDERED_ARRAY = np.array([0.1, 0.2, 0.0], dtype=np.float32)


def make_csr():
    from sparsebase_tpu import CSR

    return CSR.new(ROW_PTR.copy(), COLS.copy(), VALS.copy(), shape=(N, N))


def make_coo():
    from sparsebase_tpu import COO

    return COO.new(ROWS.copy(), COO_COLS.copy(), COO_VALS.copy(), shape=(N, N))


def make_csc():
    from sparsebase_tpu import CSC

    return CSC.new(COL_PTR.copy(), ROW_IND.copy(), VALS_CSC.copy(), shape=(N, N))


def make_pattern_csr():
    from sparsebase_tpu import CSR

    return CSR.new(ROW_PTR.copy(), COLS.copy(), None, shape=(N, N))


# -- property checks (functionality_common.inc:67-122) -----------------------
def check_reorder(order: np.ndarray, n: int) -> None:
    """order must be a permutation of [0, n)."""
    order = np.asarray(order)
    assert order.shape == (n,)
    assert np.array_equal(np.sort(order), np.arange(n))


def check_degree_ordering(order, row_ptr, ascending=True):
    """order[v] = new position of v; degrees must be monotone along the
    new ordering."""
    order = np.asarray(order)
    row_ptr = np.asarray(row_ptr)
    n = order.shape[0]
    check_reorder(order, n)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    degs = (row_ptr[1:] - row_ptr[:-1])[perm]
    if ascending:
        assert np.all(degs[:-1] <= degs[1:])
    else:
        assert np.all(degs[:-1] >= degs[1:])


def check_partition(part, n, n_parts):
    part = np.asarray(part)
    assert part.shape[0] == n
    assert part.min() >= 0 and part.max() < n_parts


def compare_csr(expected, actual):
    np.testing.assert_array_equal(np.asarray(expected.indptr), np.asarray(actual.indptr))
    np.testing.assert_array_equal(np.asarray(expected.indices), np.asarray(actual.indices))
    if expected.vals is not None:
        np.testing.assert_array_equal(np.asarray(expected.vals), np.asarray(actual.vals))


def compare_csc(expected, actual):
    np.testing.assert_array_equal(np.asarray(expected.indptr), np.asarray(actual.indptr))
    np.testing.assert_array_equal(np.asarray(expected.indices), np.asarray(actual.indices))
    if expected.vals is not None:
        np.testing.assert_array_equal(np.asarray(expected.vals), np.asarray(actual.vals))


def confirm_renumbered_csr(indptr, adj, new_indptr, new_adj, inverse_order):
    """Permuted CSR represents the same graph under the renumbering
    (functionality_common.inc:138-157)."""
    indptr, adj = np.asarray(indptr), np.asarray(adj)
    new_indptr, new_adj = np.asarray(new_indptr), np.asarray(new_adj)
    inverse_order = np.asarray(inverse_order)
    n = indptr.shape[0] - 1
    for i in range(n):
        ni = inverse_order[i]
        assert indptr[i + 1] - indptr[i] == new_indptr[ni + 1] - new_indptr[ni]
        edges = set(inverse_order[adj[indptr[i] : indptr[i + 1]]].tolist())
        new_edges = set(new_adj[new_indptr[ni] : new_indptr[ni + 1]].tolist())
        assert edges == new_edges
