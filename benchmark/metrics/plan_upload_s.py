"""plan_upload_s: host seconds of the planner's phase `plan.upload` (the
plan's buffers registered and moved to the card), from the program's own
table (`plan_phases()`)."""
from benchmark import spans


def read(rec):
    return spans.plan_phase("plan.upload")
