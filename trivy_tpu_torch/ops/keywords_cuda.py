"""The literal-code blockmask kernel: its wrapper and its build.

``code_blockmask(segments, codes)`` maps [B, L] uint8 segments and a
code operand (``keywords.code_words``: lo | hi | lo_mask | hi_mask,
each [Kp], as one 1-D int32 tensor) to [B, Kp] uint32 blockmasks, every
column computed. On a CUDA tensor it launches the hand-written kernel
(``csrc/code_blockmask.cu``) or raises; on a CPU tensor it runs
``keywords.code_blockmask_torch``, the same function in plain PyTorch.
The kernel is built at first use by ``ops/cuda_build.py``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import cuda_build
from .keywords import code_blockmask_torch

SOURCE = os.path.join(cuda_build.CSRC, "code_blockmask.cu")
BUILD_DIR = cuda_build.BUILD_DIR

_lib = None
_lib_lock = threading.Lock()


def build() -> str:
    """Compile the kernel library if this source has not been built
    yet; returns the path of the shared library."""
    return cuda_build.build(SOURCE, "code_blockmask", BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = cuda_build.load(
                SOURCE, "code_blockmask", "code_blockmask_launch",
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p],
                BUILD_DIR)
    return _lib


def _check_cuda(segments: torch.Tensor, codes: torch.Tensor) -> None:
    cuda_build.check_segments(segments)
    cuda_build.check_operand(codes, segments, "codes")
    if codes.numel() == 0 or codes.numel() % 4:
        raise ValueError(f"codes hold {codes.numel()} words, not "
                         f"4 × K with K > 0")


def code_blockmask(segments: torch.Tensor, codes: torch.Tensor) \
        -> torch.Tensor:
    """[B, L] uint8 × [4 Kp] int32 codes → [B, Kp] uint32 blockmasks."""
    if segments.device.type == "cpu":
        return code_blockmask_torch(segments, *codes.view(4, -1))
    if segments.device.type != "cuda":
        raise ValueError(f"no code_blockmask for {segments.device}")
    _check_cuda(segments, codes)
    lib = _load()
    B, L = segments.shape
    K = codes.numel() // 4
    out = torch.empty((B, K), dtype=torch.uint32, device=segments.device)
    if B == 0:
        return out
    with torch.cuda.device(segments.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.code_blockmask_launch(
            segments.data_ptr(), B, L, codes.data_ptr(), K,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"code_blockmask launch failed: CUDA error "
                           f"{err}")
    code_blockmask.launches += 1
    return out


code_blockmask.launches = 0
