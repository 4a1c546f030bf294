"""The order in which a pool's items are offered.

Every seed offers the same mix at every point of the run: each kind's
items are shuffled by the seed, then the kinds are spread evenly
(item i of a kind of n sits at i / n of the run), so a window that
sees part of the pool sees the same share of each kind whatever the
seed."""

from __future__ import annotations


def spread(items: list, kind_key: str, rng) -> list:
    kinds: dict = {}
    for it in items:
        kinds.setdefault(it[kind_key], []).append(it)
    keyed = []
    for k, group in sorted(kinds.items()):
        order = rng.permutation(len(group))
        for pos, i in enumerate(order):
            keyed.append(((pos + 0.5) / len(group), k, group[int(i)]))
    keyed.sort(key=lambda x: (x[0], x[1]))
    return [it for _, _, it in keyed]
