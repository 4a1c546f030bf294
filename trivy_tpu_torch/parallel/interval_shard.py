"""Mesh-sharded interval membership — the vuln half of the fleet
pipeline (reference: ``trivy_tpu/parallel/interval_shard.py``).

The pair table has no "rules" dimension (each row already names its
advisory), so pairs shard over the FLATTENED mesh: every device on
both axes takes a contiguous slice of the (package, advisory) rows,
padded to a multiple of ``data × rules``. Advisory tables:

  - dense path (per-dispatch [P, M] tables): sharded with the rows;
  - resident path: a ``CompiledDB``'s [N, M] tables are REPLICATED
    once per distinct device of the mesh (``device_tables(mesh)``),
    and each shard gathers only its own candidate rows from its
    device's replica.

No collective is needed: hits are element-wise per pair, so each
shard's hits come home on their own. Each shard stages its operands
in pinned host buffers, copies them up, matches and copies its hits
back into a pinned buffer on a side stream of its device, behind one
event (``mesh.per_shard``); ``ShardedHits.collect`` waits on every
shard's event before it reads any of them, so it may run on any
thread. The unsharded dispatch is the same code on ``local_mesh``.

Tracing: a caller's ``busy`` (``obs.busy.BusySpan``, the
``device_compute`` span) is stamped around each shard's match where it
runs and closed by ``collect`` after the wait; on ``local_mesh`` (the
unsharded dispatch, as the reference's) each shard's staging is
bracketed in an ``h2d_upload`` span.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..obs.trace import phase_span
from ..ops.intervals import interval_hits, interval_hits_resident
from .mesh import mesh_axis_sizes, pad_to_multiple, per_shard, wait_all


class ShardedHits:
    """Per-shard hit vectors in flight. ``collect()`` returns the [Pp]
    bool concatenation (pad rows included; callers trim)."""

    def __init__(self, launched: list, keep=(), busy=None):
        self.launched = launched
        self.keep = keep            # what the shards read: resident tables
        self.busy = busy            # the device_compute span, or None
        # host seconds of the shards' work done inline (on the CPU)
        self.compute_s = sum(part.get("compute_s", 0.0)
                             for part, _ in launched)

    def collect(self) -> np.ndarray:
        try:
            wait_all(self.launched)
        except BaseException:
            if self.busy is not None:
                self.busy.abort()
            raise
        if self.busy is not None:
            self.busy.close()
        out = np.concatenate([part["out"].numpy()
                              for part, _ in self.launched])
        # the shards' buffers may go back to their allocators only now
        self.launched = self.keep = self.busy = None
        return out


def _pad_rows(n_devices: int, *arrs):
    """Pad leading dim to a device-count multiple; pads are trimmed
    from the output, so their (harmless) hit values never surface."""
    P_ = arrs[0].shape[0]
    Pp = pad_to_multiple(P_, n_devices)
    if Pp == P_:
        return arrs, P_
    out = []
    for a in arrs:
        pad_shape = (Pp - P_,) + a.shape[1:]
        out.append(np.concatenate([a, np.zeros(pad_shape, a.dtype)]))
    return tuple(out), P_


def _stage(dev: torch.device, arrays: list, compute, busy,
           upload: bool) -> dict:
    """One shard's work, inside ``per_shard``: ``compute(*tensors)`` →
    hits on ``dev``, with the hits in host memory at the end; ``busy``
    is stamped around the match, and ``upload`` brackets the staging
    in an ``h2d_upload`` span."""
    staging = phase_span("h2d_upload", bytes=int(
        sum(a.nbytes for a in arrays))) if upload \
        else contextlib.nullcontext()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        with staging:
            tensors = [torch.from_numpy(a) for a in arrays]
        if busy is not None:
            busy.mark()
        out = compute(*tensors)
        if busy is not None:
            busy.mark()
        return {"out": out, "compute_s": time.perf_counter() - t0}
    with staging:
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        dev_in = [t.to(dev, non_blocking=True) for t in pinned]
    if busy is not None:
        busy.mark(dev)
    hits = compute(*dev_in)
    if busy is not None:
        busy.mark(dev)
    out = torch.empty(hits.shape, dtype=hits.dtype, pin_memory=True)
    out.copy_(hits, non_blocking=True)
    return {"out": out, "buffers": (pinned, dev_in, hits)}


def _launch(mesh, arrays: tuple, compute_for, keep=(),
            busy=None) -> ShardedHits:
    """Split ``arrays`` (already padded to the flat shard count) into
    contiguous row slices, one per flat shard, and run
    ``compute_for(k)`` on each; the handle keeps ``keep`` alive and
    closes ``busy`` at its collect. Only the unsharded dispatch
    (``local_mesh``) brackets its staging as ``h2d_upload``."""
    n = int(mesh.devices.size)
    rows = arrays[0].shape[0] // n

    def one(k: int, dev: torch.device) -> dict:
        part = [np.ascontiguousarray(a[k * rows:(k + 1) * rows])
                for a in arrays]
        return _stage(dev, part, compute_for(k), busy, mesh.local)

    return ShardedHits(per_shard(mesh, one), keep, busy)


def sharded_interval_hits(mesh, pkg_rank, v_lo, v_hi, s_lo, s_hi,
                          flags, busy=None) -> np.ndarray:
    """[P] ranks × per-pair [P, M] tables → [P] bool, pairs sharded
    over every device in the mesh."""
    n = pkg_rank.shape[0]
    return sharded_interval_hits_async(
        mesh, pkg_rank, v_lo, v_hi, s_lo, s_hi, flags,
        busy=busy).collect()[:n]


def sharded_interval_hits_async(mesh, pkg_rank, v_lo, v_hi, s_lo,
                                s_hi, flags, busy=None) -> ShardedHits:
    """Non-blocking variant for the slot runtime: pads and launches
    every shard, returns the handle (its rows may carry device-multiple
    padding past the input length — pad rows are inert, callers trim
    on collect)."""
    d, r = mesh_axis_sizes(mesh)
    arrays, _n = _pad_rows(d * r, pkg_rank, v_lo, v_hi, s_lo, s_hi,
                           flags)
    return _launch(mesh, arrays, lambda k: interval_hits, busy=busy)


def replicate_tables(mesh, tables: tuple) -> list:
    """Place advisory tables (numpy) on every device of the mesh, once
    per distinct device: one tuple of tensors per flat shard, shards
    on one device sharing it."""
    placed = {d: tuple(torch.tensor(np.asarray(a), device=d)
                       for a in tables) for d in mesh.distinct}
    return [placed[d] for d in mesh.flat]


def sharded_interval_hits_resident(mesh, pkg_rank, row_idx,
                                   tables: list, busy=None) -> np.ndarray:
    """[P] ranks + [P] candidate-row indices against replicated
    resident tables (one tuple per flat shard: ``replicate_tables`` or
    ``CompiledDB.device_tables(mesh)``) → [P] bool."""
    n = pkg_rank.shape[0]
    return sharded_interval_hits_resident_async(
        mesh, pkg_rank, row_idx, tables, busy=busy).collect()[:n]


def sharded_interval_hits_resident_async(mesh, pkg_rank, row_idx,
                                         tables: list, busy=None) \
        -> ShardedHits:
    """Non-blocking resident variant (see
    ``sharded_interval_hits_async``): launch only, caller trims. Each
    shard gathers from its own device's replica."""
    d, r = mesh_axis_sizes(mesh)
    arrays, _n = _pad_rows(d * r, pkg_rank, row_idx)

    def compute_for(k: int):
        def match(rank, idx):
            return interval_hits_resident(rank, idx, *tables[k])
        return match

    return _launch(mesh, arrays, compute_for, keep=tables, busy=busy)
