"""Measurement utilities: per-class timing (`profile_engines`), profiler
traces (`trace_context`) and the interleaved A/B harness (`abtest`)."""
from .profiling import profile_engines, trace_context

__all__ = ["profile_engines", "trace_context"]
