"""plan_stream_s: host seconds of the planner's phase `plan.stream` (the
stream classes' geometry and packing), from the program's own table
(`plan_phases()`)."""
from benchmark import spans


def read(rec):
    return spans.plan_phase("plan.stream")
