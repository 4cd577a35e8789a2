"""plan_convert_s: host seconds of the planner's phase `plan.convert`
(tile_create, the CSR converted to tiles), from the program's own table
(`plan_phases()`)."""
from benchmark import spans


def read(rec):
    return spans.plan_phase("plan.convert")
