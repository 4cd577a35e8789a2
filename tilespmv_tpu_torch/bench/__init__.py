"""Benchmarking: the harness (`benchmark_op`, results.csv), the card's
roofline figures and the corpus sweep."""
from .harness import BenchResult, append_results_csv, benchmark_op
from .roofline import detect_chip, peak_bandwidth_gbps, roofline_gflops
from .sweep import sweep

__all__ = ["BenchResult", "benchmark_op", "append_results_csv", "sweep",
           "detect_chip", "peak_bandwidth_gbps", "roofline_gflops"]
