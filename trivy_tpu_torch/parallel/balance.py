"""Work-volume-balanced shard assignment (docs/performance.md).

The mesh's data axis splits the leading batch dimension into equal
CONTIGUOUS chunks, so whatever order the host packs rows in IS the
device assignment. Packing files in arrival order lets one fat image
pile its segments into a single chunk while the tail chunks carry
mostly padding — the per-device occupancy skew the round-5 mesh
curve surfaced. This module assigns items to shards by measured byte
volume (greedy LPT: heaviest item to the lightest shard) so every
chunk carries near-equal real work, and reports the per-shard
occupancy the metrics/bench layers surface.
"""

from __future__ import annotations


def balance_by_volume(volumes: list, n_shards: int) -> list:
    """Greedy LPT assignment: ``volumes[i]`` bytes → shard id.

    Returns ``assign`` with ``assign[i] ∈ [0, n_shards)``. Items are
    placed heaviest-first onto the currently lightest shard — the
    classic 4/3-approximation to minimum makespan, which is as good
    as it gets for an online packer and exact for the uniform-volume
    case. Deterministic: ties break on the lower shard id and the
    original item order."""
    assign = [0] * len(volumes)
    if n_shards <= 1 or len(volumes) <= 1:
        return assign
    loads = [0] * n_shards
    order = sorted(range(len(volumes)),
                   key=lambda i: (-volumes[i], i))
    for i in order:
        s = min(range(n_shards), key=lambda k: (loads[k], k))
        assign[i] = s
        loads[s] += volumes[i]
    return assign


def shard_occupancy(volumes: list, assign: list,
                    n_shards: int) -> list:
    """Per-shard real-volume share of the padded capacity every
    shard is booked at (the max shard's volume — the mesh pads each
    chunk to the widest one). 1.0 everywhere = perfectly balanced;
    a low entry is a device that mostly multiplies padding."""
    loads = [0] * n_shards
    for i, s in enumerate(assign):
        loads[s] += volumes[i]
    cap = max(loads) if loads else 0
    if not cap:
        return [1.0] * n_shards
    return [round(v / cap, 4) for v in loads]
