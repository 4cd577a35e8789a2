"""tilespmv-tpu-torch: the tiled SpMV framework on PyTorch and CUDA.

Port of tilespmv_tpu (JAX/Pallas, the reference) to an NVIDIA H100:
matrices are partitioned into 16x16 tiles, each tile auto-selected among
seven storage formats, and y = A*x is computed by the lane-major
execution plan's class kernels — band, dense, W-class and stream —
hand-written in CUDA C++ for sm_90a (ops/cuda/csrc), each with a plain
PyTorch version beside it (ops/cuda/reference.py). The NumPy host side
(conversion, planning, the tile-by-tile CPU engine `spmv_cpu`, plan
files) is this package's own copy, held bit-equal to tilespmv_tpu's by
the tests. The command-line tool is `python -m tilespmv_tpu_torch.cli`.
Imports torch and numpy, never JAX.
"""
from .config import (DEFAULT_CONFIG, FMT_COO, FMT_CSR, FMT_DNS, FMT_DNSCOL,
                     FMT_DNSROW, FMT_ELL, FMT_HYB, FORMAT_NAMES, TileConfig)
from .core.convert import tile_create
from .core.tile_matrix import TileMatrix
from .io.mmio import CSRMatrix, csr_from_coo, load_mtx, save_mtx
from .ops.cpu_reference import spmv_cpu
from .ops.spmv import TileSpMV, spmm, spmv

__version__ = "0.1.0"

__all__ = [
    "TileConfig", "DEFAULT_CONFIG", "TileMatrix", "CSRMatrix",
    "tile_create", "load_mtx", "save_mtx", "csr_from_coo", "spmv_cpu",
    "TileSpMV", "spmv", "spmm",
    "FORMAT_NAMES", "FMT_CSR", "FMT_COO", "FMT_ELL", "FMT_HYB", "FMT_DNS",
    "FMT_DNSROW", "FMT_DNSCOL",
]
