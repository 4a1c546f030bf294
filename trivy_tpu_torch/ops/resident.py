"""Device residency for tables that serve many dispatches.

``device_tables(device)`` uploads ``_resident_arrays()`` once per
device and hands back the same tensors on every later call;
``device_array(device, name, make)`` does the same for one more array
a launch picks by ``name``; ``invalidate_device()`` drops them all. A table's content is fixed at
build (its ``rules_hash`` names it), so one upload per (rules_hash,
device) is one upload per (table, device). ``device_stats()`` counts
uploads and dispatches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class ResidentTables:
    def _init_resident(self) -> None:
        self._device: dict = {}
        self._device_lock = threading.Lock()
        self._device_stats = {"uploads": 0, "upload_bytes": 0,
                              "dispatches": 0, "invalidations": 0}

    def _resident_arrays(self) -> tuple:
        raise NotImplementedError

    def device_tables(self, device) -> tuple:
        key = str(torch.device(device))
        with self._device_lock:
            placed = self._device.get(key)
            if placed is None:
                arrs = self._resident_arrays()
                placed = tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(key)
                    for a in arrs)
                self._device[key] = placed
                self._device_stats["uploads"] += 1
                self._device_stats["upload_bytes"] += int(
                    sum(a.nbytes for a in arrs))
            self._device_stats["dispatches"] += 1
        return placed

    def device_array(self, device, name, make) -> torch.Tensor:
        """``make()`` (a numpy array) on ``device``, uploaded once per
        (device, ``name``) and counted with the other uploads."""
        key = (str(torch.device(device)), name)
        with self._device_lock:
            placed = self._device.get(key)
            if placed is None:
                arr = np.ascontiguousarray(make())
                placed = torch.from_numpy(arr).to(key[0])
                self._device[key] = placed
                self._device_stats["uploads"] += 1
                self._device_stats["upload_bytes"] += int(arr.nbytes)
        return placed

    def invalidate_device(self) -> None:
        """Drop every device copy (the next dispatch re-uploads)."""
        with self._device_lock:
            if not self._device:
                return
            self._device.clear()
            self._device_stats["invalidations"] += 1

    def device_stats(self) -> dict:
        with self._device_lock:
            return dict(self._device_stats)
