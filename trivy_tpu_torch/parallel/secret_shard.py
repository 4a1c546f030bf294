"""Mesh-sharded secret sieve: async per-shard submission (reference:
``trivy_tpu/parallel/secret_shard.py``).

  1. files are LPT-assigned to per-shard row blocks of one buffer
     (``parallel.balance``, ``BatchSecretScanner._layout``);
  2. the files' rows PACK as host-pool tasks running concurrently
     (``BatchSecretScanner._fill``, as on one device);
  3. the rows split into one equal contiguous chunk per device of the
     mesh (``DfaTable.mesh_sieve``): each chunk's ``dfa_blockmask``
     launch runs on its device's side stream behind its own event, and
     ``start`` returns BEFORE the devices finish, so the caller's host
     work (squash, interval prep, the next batch's packing) overlaps
     the sieve;
  4. at collect time every shard's event is waited for, and per-block
     mask decode (nonzero + dict build) fans back over the host pool
     and the partial results merge.

The reference runs one ``shard_map`` program per shape, because a
per-device dispatch loop paid a jit compile per (device, shape); the
port runs eagerly, so it launches per shard. The DFA band table is
KBs, so every device holds the FULL table (``device_tables(mesh)``,
once per distinct device) and the data axis gets ALL the parallelism;
no collective is needed, each shard's masks come home on their own.
Device chunks need not align with the LPT blocks: the decode reads the
joined masks by row.

``sharded_blockmask`` (the reference's round-5 literal kernel over
both mesh axes) is kept for the ops-level tests and the literal
``run_blockmask`` path; its rules-axis ``all_gather`` is a
concatenation of the per-rule-shard blocks along K.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs.busy import child_span, pending_busy
from ..ops.keywords import CODE_CHUNK, code_words
from ..secret.metrics import SECRET_METRICS
from .mesh import mesh_axis_sizes, pad_to_multiple, per_shard, wait_all


class ShardedSieve:
    """One batch's async sharded sieve submission. Built by
    ``BatchSecretScanner._dispatch`` (mesh path): segment packing fans
    over the host pool, one ``dfa_blockmask`` launch per device chunk
    (each behind its own event), and per-block result decode fans back
    over the pool at collect time. Single-producer,
    single-consumer; ``decode`` may run on any thread."""

    def __init__(self, scanner, metas: list):
        self.scanner = scanner
        self.metas = metas
        self.lay = scanner._layout(metas)
        self.occupancy = self.lay["occupancy"]
        self.pack_s = 0.0
        self.device_s = 0.0
        self._out = None

    def start(self) -> "ShardedSieve":
        sc = self.scanner
        lay = self.lay
        n_shards, rps = lay["n_shards"], lay["rows_per_shard"]
        self.n_valid = lay["B"]
        n_flat = int(sc.mesh.devices.size)
        # the rows split evenly over every device, in chunks of whole
        # 32-row tiles (the reference's pallas tile)
        B = pad_to_multiple(lay["B"], n_flat * 32)
        self.seg_file = lay["seg_file"]
        self.seg_pos = lay["seg_pos"]
        self.rps = rps if n_shards > 1 else B

        # pack_s is WALL time across the parallel fills
        t0 = time.perf_counter()
        self.buf = buf = sc._fill(self.metas, lay, B)
        self.pack_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        # async: returns before the devices finish; each shard's launch
        # is stamped where it runs, for the dfa_scan span of decode()
        self.busy = pending_busy()
        self._out = sc.table.mesh_sieve(sc.mesh, buf,
                                        tuple(sc.plan.run_specs),
                                        busy=self.busy)
        self.device_s += time.perf_counter() - t0
        # the LPT blocks that hold files (the reference's count)
        SECRET_METRICS.inc("shards_dispatched", len(
            {row0 // rps for row0, _ in lay["layout"]}))
        return self

    def decode(self) -> tuple:
        """Wait for every shard, join the masks and decode them in
        parallel: returns (file_codes, runs_map) merged across shard
        blocks — ``file_codes``: file index → {pattern col: [(seg
        offset, blockmask)]}; ``runs_map``: file index → {run-spec
        idx}."""
        from ..runtime.hostpool import map_in_pool
        K = self.scanner.table.n_patterns
        t0 = time.perf_counter()
        # the join: the dfa_scan busy span the timeline counts, from the
        # earliest shard's start to the latest shard's end (the
        # reference's dfa_scan(fetch=True) around its mesh join)
        span = child_span("dfa_scan", fetch=True,
                          segments=int(self.n_valid))
        try:
            wait_all(self._out)
        except BaseException:
            self.busy.abort(span)
            raise
        self.busy.close(span)
        masks = np.concatenate([part["masks"].cpu().numpy()
                                for part, _ in self._out])[:self.n_valid, :K]
        runs = np.concatenate([part["hits"].cpu().numpy()
                               for part, _ in self._out])[:self.n_valid]
        # the segments may go back to the allocator only now
        self._out = self.buf = None
        self.device_s += time.perf_counter() - t0

        seg_file, seg_pos = self.seg_file, self.seg_pos
        blocks = [(r0, min(r0 + self.rps, self.n_valid))
                  for r0 in range(0, self.n_valid, self.rps)]

        def decode_block(span):
            row0, row1 = span
            codes: dict = {}
            m = masks[row0:row1]
            for si, ci in zip(*np.nonzero(m)):
                fidx = seg_file[row0 + int(si)]
                if fidx < 0:
                    continue              # shard-padding row
                codes.setdefault(fidx, {}).setdefault(
                    int(ci), []).append(
                        (seg_pos[row0 + int(si)],
                         int(m[si, ci])))
            rmap: dict = {}
            for si, sp in zip(*np.nonzero(runs[row0:row1])):
                fidx = seg_file[row0 + int(si)]
                if fidx < 0:
                    continue
                rmap.setdefault(fidx, set()).add(int(sp))
            return codes, rmap

        SECRET_METRICS.inc("decode_tasks", len(blocks))
        file_codes: dict = {}
        runs_map: dict = {}
        for codes, rmap in map_in_pool(decode_block, blocks):
            # a file lives wholly inside one shard block, so
            # per-file entries never interleave across partials
            file_codes.update(codes)
            for fidx, s in rmap.items():
                runs_map.setdefault(fidx, set()).update(s)
        return file_codes, runs_map


# ---------------------------------------------------------------------
# the literal-code kernel over both mesh axes
# ---------------------------------------------------------------------

def rules_shard_codes(codes: tuple, r: int) -> list:
    """The four code arrays padded to a multiple of ``r × CODE_CHUNK``
    (pad code 0 under full masks) and cut into ``r`` equal column
    chunks: one (lo, hi, lo_mask, hi_mask) tuple per rules shard."""
    K = codes[0].shape[0]
    Kp = pad_to_multiple(K, r * CODE_CHUNK)
    padded = []
    for i, a in enumerate(codes):
        a = np.asarray(a)
        if Kp != K:
            pad = np.zeros(Kp - K, a.dtype)
            if i >= 2:
                pad = pad + np.uint32(0xFFFFFFFF)
            a = np.concatenate([a, pad])
        padded.append(a)
    cols = Kp // r
    return [tuple(a[j * cols:(j + 1) * cols] for a in padded)
            for j in range(r)]


def sharded_blockmask(mesh, segments: np.ndarray, codes: tuple) \
        -> np.ndarray:
    """[B, L] segments × padded code arrays → [B, K] uint32 masks.

    Rows split over the data axis, codes over the rules axis: one
    ``code_blockmask`` launch per (data, rules) block, on that block's
    device. Codes are padded so each rules shard holds a CODE_CHUNK
    multiple; pad codes never match real text (zero code + full mask)
    and their columns, like the pad rows, are sliced off here."""
    from ..ops.keywords_cuda import code_blockmask
    d, r = mesh_axis_sizes(mesh)
    B, L = segments.shape
    K = codes[0].shape[0]
    Bp = pad_to_multiple(B, d)

    if Bp != B:
        segments = np.concatenate(
            [segments, np.zeros((Bp - B, L), segments.dtype)])
    shards = rules_shard_codes(codes, r)
    rows = Bp // d

    def block(k: int, dev: torch.device) -> dict:
        i, j = divmod(k, r)          # flat shards are data-major
        seg = torch.from_numpy(np.ascontiguousarray(
            segments[i * rows:(i + 1) * rows])).to(dev)
        cw = code_words(shards[j], dev)
        return {"seg": seg, "codes": cw, "masks": code_blockmask(seg, cw)}

    launched = per_shard(mesh, block)
    wait_all(launched)
    # the rules axis rejoins along K, the data axis along B
    grid = [[launched[i * r + j][0]["masks"].cpu().numpy()
             for j in range(r)] for i in range(d)]
    return np.block(grid)[:B, :K]
