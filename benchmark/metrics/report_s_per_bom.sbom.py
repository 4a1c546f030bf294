"""Seconds of the scheduler's report stage (``report`` spans: the
scanner's finish) per BOM completed in the window."""
from benchmark.metrics import per_item

LAYER = "report"
SOURCE = "program_span"
UNIT = "s"
MOVES = "sboms_per_s"


def read(trace):
    return per_item(trace, trace.named("report"))
