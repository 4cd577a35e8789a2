"""Per-card roofline model.

Port of tilespmv_tpu/bench/roofline.py for NVIDIA H100 cards. The
reference reports GFLOPS = 2*nnz/t (tilespmv_cuda.h:1138) and the CSR5
program adds a bandwidth figure GB/s = bytes/t
(external/CSR5_cuda/detail/utils.h:10-20). SpMV is bound by memory
bandwidth, so the card's figure of merit is the share of its peak HBM
bandwidth a call sustains. The peaks are NVIDIA's published H100 data
sheet figures at each part's full power limit (dense, no sparsity;
FP32 and FP64 outside the tensor cores); this module is their one copy
(utils/profiling.py reads the SXM part's).
"""
from __future__ import annotations

import math

import torch

# peak HBM bandwidth per card, GB/s
HBM_GBPS = {
    "h100_sxm": 3350.0,
    "h100_pcie": 2000.0,
    "h100_nvl": 3900.0,
    "cpu": 50.0,  # rough, for running the harness on the host's CPU
}

# peak FLOP/s per card by value size in bytes (2: BF16 on the tensor
# cores, 4: FP32 and 8: FP64 outside them), in GFLOPS: a physical bound
# on a benchmark result, not a target
PEAK_GFLOPS = {
    "h100_sxm": {2: 989e3, 4: 67e3, 8: 34e3},
    "h100_pcie": {2: 756e3, 4: 51e3, 8: 26e3},
    "h100_nvl": {2: 835e3, 4: 60e3, 8: 30e3},
    "cpu": {2: 2e3, 4: 2e3, 8: 1e3},
}

# a CUDA card of none of these parts: no published figure to hold it to
UNKNOWN = "unknown_gpu"


def detect_chip() -> str:
    """The part of card 0 from torch.cuda.get_device_name ("h100_sxm",
    "h100_pcie", "h100_nvl"), "cpu" without a card, UNKNOWN for any
    other card."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0).lower()
    if "h100" not in name:
        return UNKNOWN
    if "pcie" in name:
        return "h100_pcie"
    if "nvl" in name:
        return "h100_nvl"
    if "sxm" in name or "hbm3" in name:
        return "h100_sxm"
    return UNKNOWN


def peak_bandwidth_gbps(chip: str | None = None) -> float:
    """Peak HBM GB/s of `chip` (default: this process's card); NaN for
    UNKNOWN."""
    return HBM_GBPS.get(chip or detect_chip(), math.nan)


def peak_compute_gflops(chip: str | None = None, vbytes: int = 4) -> float:
    """Peak GFLOPS of `chip` for values of `vbytes` bytes; NaN for
    UNKNOWN."""
    return PEAK_GFLOPS.get(chip or detect_chip(), {}).get(vbytes, math.nan)


def roofline_gflops(flops: int, bytes_accessed: int,
                    chip: str | None = None) -> float:
    """Max achievable GFLOPS for a kernel moving `bytes_accessed` bytes."""
    bw = peak_bandwidth_gbps(chip) * 1e9
    seconds_min = bytes_accessed / bw
    return flops / seconds_min / 1e9
