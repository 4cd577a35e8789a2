"""Plan pieces shared by the execution engines.

Port of the part of tilespmv_tpu/ops/plan.py the lane plan uses: the
sorted-COO residual of leftover entries (HYB overflow), executed as a
scatter-add by global row.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ResidualEngine:
    """Sorted-COO residual (global indices), segment-sum by row."""
    val: Any        # (nnz,) f32
    row: Any        # (nnz,) int32 sorted ascending
    col: Any        # (nnz,) int32
