"""BOMs per device batch of the scheduler in the SBOM service."""
from benchmark.metrics import batch_items

LAYER = "fleet runtime and scheduler"
SOURCE = "program_counter"
UNIT = "boms/batch"
MOVES = "sboms_per_s"


def read(trace):
    return batch_items(trace)
