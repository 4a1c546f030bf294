"""Host utilities shared by the analyzers and the fleet runtime."""

import contextlib
import gc


@contextlib.contextmanager
def defer_gc():
    """Suspend generational GC around allocation-heavy fleet loops
    (copied from ``trivy_tpu/utils/__init__.py:8``).

    With the compiled advisory DB resident (48k+ Python row tuples),
    every young-generation collection walks that long-lived heap;
    measured on the 10k-SBOM bench this made decode 2.4x slower.
    Objects created inside the block are collected by the explicit
    collect() on exit, so cycles cannot accumulate across batches."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
            gc.collect()
