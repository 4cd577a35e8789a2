"""Host utilities (`host`: scans, searches, the CSR transpose) and
measurement utilities: per-class timing (`profile_engines`), profiler
traces (`trace_context`) and the interleaved A/B harness (`abtest`)."""
from .host import (binary_search_right_boundary, csr_transpose,
                   exclusive_scan, sort_key_val)
from .profiling import profile_engines, trace_context

__all__ = ["exclusive_scan", "csr_transpose",
           "binary_search_right_boundary", "sort_key_val",
           "profile_engines", "trace_context"]
