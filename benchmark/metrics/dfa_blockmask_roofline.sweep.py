"""The secret sieve kernel's share of its roofline: the least time
the segments of every ``dfa_scan`` launch need (``roofline``, a lower
bound) over the ``dfa_sieve_kernel`` time in the profiler's trace."""
from benchmark.roofline import sieve_bound_ms

LAYER = "secret sieve"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "images_per_s"
KERNEL = "dfa_sieve_kernel"


def read(trace):
    kernel_us = sum(d for name, _, d in trace.kernels if KERNEL in name)
    spans = [s for s in trace.named("dfa_scan", segments=None)
             if not s.attrs.get("host") and not s.attrs.get("fetch")
             and s.start >= trace.t_start]
    if kernel_us <= 0 or not spans or not trace.sieve:
        return None
    bound = sum(sieve_bound_ms(int(s.attrs["segments"]), trace.sieve)[0]
                for s in spans)
    return 100.0 * bound / (kernel_us / 1e3)
