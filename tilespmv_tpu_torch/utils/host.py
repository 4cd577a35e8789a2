"""Host-side scan/search/transpose utilities.

Port of tilespmv_tpu/utils/host.py (NumPy, bit-equal to it): vectorized
equivalents of the reference's host helpers (reference: src/utils.h —
exclusive_scan :34, quick_sort_key_val_pair :128,
binary_search_right_boundary_item_kernel :6, matrix_transposition :172).
"""
from __future__ import annotations

import numpy as np

from ..io.mmio import CSRMatrix


def exclusive_scan(counts: np.ndarray, dtype=np.int64) -> np.ndarray:
    """[c0, c1, ...] -> [0, c0, c0+c1, ...] (length n+1)."""
    out = np.zeros(np.shape(counts)[0] + 1, dtype=dtype)
    np.cumsum(counts, out=out[1:])
    return out


def binary_search_right_boundary(boundaries: np.ndarray,
                                 keys: np.ndarray) -> np.ndarray:
    """For each key, the segment index whose [boundaries[i],
    boundaries[i+1]) range contains it (reference utils.h:6-31 semantics,
    vectorized)."""
    return np.searchsorted(boundaries, keys, side="right") - 1


def csr_transpose(csr: CSRMatrix) -> CSRMatrix:
    """CSR -> CSR of the transpose (the reference's CSR->CSC conversion,
    utils.h:172-211), via histogram + scan + scatter."""
    m, n = csr.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(csr.indptr))
    order = np.lexsort((rows, csr.indices))
    new_rows = csr.indices[order].astype(np.int64)
    indptr = exclusive_scan(np.bincount(new_rows, minlength=n)[:n])
    return CSRMatrix((n, m), indptr, rows[order].astype(np.int32),
                     csr.data[order])


def sort_key_val(keys: np.ndarray, vals: np.ndarray):
    """Sort (key, val) pairs by key (reference quick_sort_key_val_pair,
    utils.h:128 — vectorized instead of recursive)."""
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]
