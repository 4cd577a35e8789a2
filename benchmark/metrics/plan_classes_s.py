"""plan_classes_s: host seconds of the planner's phase `plan.classes`
(the plan's classes routed and packed, the stream classes' own phase
left out), from the program's own table (`plan_phases()`)."""
from benchmark import spans


def read(rec):
    return spans.plan_phase("plan.classes")
