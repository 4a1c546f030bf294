"""The DFA blockmask kernel: its wrapper, its build, and its plain
PyTorch version.

``dfa_blockmask(segments, table, dev, run_specs)`` maps [B, L] uint8
segments and a resident ``DfaTable`` to [B, n_patterns] uint16
blockmasks and, from the same launch, the class-run gate's hits [B,
n_specs] bool. On a CUDA tensor it launches the hand-written kernel
(``csrc/dfa_blockmask.cu``) or raises; on a CPU tensor it runs
``dfa_masks_torch`` (and ``ops/runs.py::run_hits``), the same function
in plain PyTorch.

The kernel is built at first use by ``ops/cuda_build.py``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_build
from .dfa import H_EROS, H_SETS, H_UNITS, chain_len
from .keywords import MAX_CODE_LEN, block_bits, blockmask_bits, \
    pack_code, window_words as _lo_hi_words
from .runs import erode, membership, run_hits, shift_left

SOURCE = os.path.join(cuda_build.CSRC, "dfa_blockmask.cu")
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the kernel library if this source has not been built
    yet; returns the path of the shared library."""
    return cuda_build.build(SOURCE, "dfa_blockmask", BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = cuda_build.load(
                SOURCE, "dfa_blockmask", "dfa_blockmask_launch",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
                BUILD_DIR)
    return _lib


def _check_cuda(segments: torch.Tensor, desc: torch.Tensor) -> None:
    cuda_build.check_segments(segments)
    cuda_build.check_operand(desc, segments, "kernel descriptor")


def dfa_blockmask(segments: torch.Tensor, table, dev: tuple,
                  run_specs: tuple = ()) -> tuple:
    """[B, L] uint8 × resident table → (masks [B, n_patterns] uint16,
    hits [B, n_specs] bool) from one launch; ``run_specs`` are
    ``RunSpec``s (none: hits has no columns). ``dev`` is
    ``table.device_tables(device)``, which the plain version reads."""
    run_specs = tuple(run_specs)
    if segments.device.type == "cpu":
        return (dfa_masks_torch(segments, table, dev),
                run_hits(segments, run_specs))
    if segments.device.type != "cuda":
        raise ValueError(f"no dfa_blockmask for {segments.device}")
    lib = _load()
    desc = table.device_desc(segments.device, run_specs)
    _check_cuda(segments, desc)
    head = table.kernel_desc(run_specs)
    B, L = segments.shape
    out = torch.empty((B, table.n_patterns), dtype=torch.uint16,
                      device=segments.device)
    hits = torch.empty((B, len(run_specs)), dtype=torch.bool,
                       device=segments.device)
    if B:
        with torch.cuda.device(segments.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.dfa_blockmask_launch(
                segments.data_ptr(), B, L, desc.data_ptr(), desc.numel(),
                table.n_patterns, int(head[H_SETS]), int(head[H_EROS]),
                int(head[H_UNITS]), out.data_ptr(), hits.data_ptr(),
                stream)
        if err != 0:
            raise RuntimeError(f"dfa_blockmask launch failed: CUDA error "
                               f"{err}")
        dfa_blockmask.launches += 1
    return out, hits


dfa_blockmask.launches = 0


# ---------------------------------------------------------------------
# the plain version (any device; what the CPU path runs)
# ---------------------------------------------------------------------

def _shift_right(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[:, i] ← a[:, i-k], zero-filled at the head."""
    if k == 0:
        return a
    out = torch.zeros_like(a)
    out[:, k:] = a[:, :-k]
    return out


def _lit_pred(lo_sh: list, hi_sh: list, words) -> torch.Tensor:
    """[B, L] bool: a literal whose chunk j packs to ``words[j]`` =
    (lo, hi, lo_mask, hi_mask) starts at each position."""
    p = None
    for j, (klo, khi, mlo, mhi) in enumerate(words):
        cmp = ((lo_sh[j] & mlo) == klo) & ((hi_sh[j] & mhi) == khi)
        p = cmp if p is None else p & cmp
    return p


def window_words(segments: torch.Tensor, nch: int) -> tuple:
    """Lowered little-endian window words: (lo_sh, hi_sh), each a list
    of ``nch`` [B, L] int64 tensors, entry j the lo/hi word of the 8
    bytes at position + 8j (zero past L)."""
    lo, hi = _lo_hi_words(segments)
    return ([shift_left(lo, 8 * j) for j in range(nch)],
            [shift_left(hi, 8 * j) for j in range(nch)])


def chain_unit_preds(segments: torch.Tensor, table, words: tuple):
    """Per chain, in table order: its units' [B, L] bool predicates in
    unit order, each moved to the chain END (head zero-filled). A chain
    hits where all of them hold. ``words`` is ``window_words``."""
    lo_sh, hi_sh = words
    xi = segments.to(torch.int32)
    for units in table.chains:
        K = chain_len(units)
        preds = []
        off = 0
        for u in units:
            if u[0] == "lit":
                data = u[1]
                pred = _lit_pred(lo_sh, hi_sh, [
                    pack_code(data[j * MAX_CODE_LEN:
                                   (j + 1) * MAX_CODE_LEN])
                    for j in range(-(-len(data) // MAX_CODE_LEN))])
                ulen = len(data)
            else:
                _, ranges, n = u
                # membership on RAW bytes; past L nothing is a member
                pred, ulen = erode(membership(xi, ranges), n), n
            # start-position predicate, moved to the chain END
            preds.append(_shift_right(pred, K - 1 - off))
            off += ulen
        yield preds


def _masks_rows(segments: torch.Tensor, table, band: tuple) \
        -> torch.Tensor:
    B, L = segments.shape
    dev = segments.device
    bits = block_bits(dev)
    words = window_words(segments, table.max_chunks)
    lo_sh, hi_sh = words

    out = torch.zeros((B, table.n_patterns), dtype=torch.int64,
                      device=dev)
    for gi, g in enumerate(table.groups):
        glo, ghi, glom, ghim = band[4 * gi:4 * gi + 4]
        for k in range(g.count):      # pad columns are never computed
            kw = [(glo[j, k], ghi[j, k], glom[j, k], ghim[j, k])
                  for j in range(g.chunks)]
            out[:, g.start + k] = blockmask_bits(
                _lit_pred(lo_sh, hi_sh, kw), bits)

    for ci, preds in enumerate(chain_unit_preds(segments, table, words)):
        acc = preds[0]
        for p in preds[1:]:
            acc = acc & p
        out[:, len(table.literals) + ci] = blockmask_bits(acc, bits)
    return out.to(torch.uint16)


def dfa_masks_torch(segments: torch.Tensor, table, dev: tuple,
                    rows: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of the kernel's masks: [B, L] uint8 → [B,
    n_patterns] uint16 blockmasks, on the segments' device, ``rows``
    segments at a time to bound the int64 intermediates. ``dev`` is
    ``table.device_tables(device)``: the int64 band arrays."""
    band = dev
    B = segments.shape[0]
    if B <= rows:
        return _masks_rows(segments, table, band)
    return torch.cat([_masks_rows(segments[i:i + rows], table, band)
                      for i in range(0, B, rows)])
