"""The device's idle share of the profiled sweep window."""
from benchmark.metrics import device_idle_pct

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "images_per_s"


def read(trace):
    return device_idle_pct(trace)
