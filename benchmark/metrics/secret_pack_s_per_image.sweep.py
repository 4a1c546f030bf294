"""Seconds of the secret sieve's host packing (``pack`` spans with
``files=``) per image completed in the window."""
from benchmark.metrics import per_item

LAYER = "secret host side"
SOURCE = "program_span"
UNIT = "s"
MOVES = "images_per_s"


def read(trace):
    return per_item(trace, trace.named("pack", files=None))
