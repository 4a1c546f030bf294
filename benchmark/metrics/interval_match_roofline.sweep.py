"""The resident interval match's share of its bytes bound in the
sweep."""
from benchmark.metrics import interval_roofline_pct

LAYER = "vulnerability match"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "images_per_s"


def read(trace):
    return interval_roofline_pct(trace)
