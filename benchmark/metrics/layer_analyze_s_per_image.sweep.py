"""Seconds of layer walk and analysis (``layer_analyze`` spans) per
image completed in the window."""
from benchmark.metrics import per_item

LAYER = "walk and analyze"
SOURCE = "program_span"
UNIT = "s"
MOVES = "images_per_s"


def read(trace):
    return per_item(trace, trace.named("layer_analyze"))
