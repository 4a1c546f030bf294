"""Seconds of the interval match's host packing (``pack`` spans with
``jobs=``) per 1,000 jobs packed."""
from benchmark.metrics import span_seconds

LAYER = "vulnerability match"
SOURCE = "program_span"
UNIT = "s"
MOVES = "sboms_per_s"


def read(trace):
    spans = trace.named("pack", jobs=None)
    jobs = sum(int(s.attrs["jobs"]) for s in spans)
    if not jobs:
        return None
    return span_seconds(spans) / (jobs / 1000.0)
