"""Images per device batch of the scheduler in the sweep."""
from benchmark.metrics import batch_items

LAYER = "fleet runtime and scheduler"
SOURCE = "program_counter"
UNIT = "images/batch"
MOVES = "images_per_s"


def read(trace):
    return batch_items(trace)
