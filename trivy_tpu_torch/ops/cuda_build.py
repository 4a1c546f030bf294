"""Build and load the port's hand-written CUDA kernels, and the input
checks their wrappers share.

Every kernel source in ``csrc/`` has a plain C interface, so it is
compiled with ``nvcc`` alone (no PyTorch headers: seconds, not
minutes) into a shared library and loaded with ``ctypes``. A library
lands in ``<build_dir>/<hash of source, name and flags>/``, beside the
``-Xptxas -v`` report of its build (``ptxas.txt``); a source that
changes builds anew, one that does not is never rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc(lib_name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError(f"no CUDA toolkit found to build the "
                           f"{lib_name} kernel (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: str, lib_name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``source`` into ``lib<lib_name>.so`` unless this source,
    name and flags were built already; returns the library's path."""
    with open(source, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + repr((lib_name, NVCC_FLAGS)).encode()) \
        .hexdigest()[:16]
    out_dir = os.path.join(build_dir, key)
    lib = os.path.join(out_dir, f"lib{lib_name}.so")
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc(lib_name)
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {lib_name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)
    return lib


def check_segments(segments) -> None:
    """What every kernel takes as its segment batch: [B, L] uint8,
    contiguous, 16-byte aligned (rows are read as 16-byte vectors),
    L a multiple of 128 (16 blocks of a multiple of 8 bytes)."""
    if segments.dtype != torch.uint8 or segments.dim() != 2:
        raise ValueError(f"segments must be [B, L] uint8, got "
                         f"{tuple(segments.shape)} {segments.dtype}")
    if not segments.is_contiguous() or segments.data_ptr() % 16:
        raise ValueError("segments must be contiguous and 16-byte "
                         "aligned")
    if segments.shape[1] % 128:
        raise ValueError(f"segment length {segments.shape[1]} is not "
                         f"a multiple of 128")


def check_operand(t, segments, what: str) -> None:
    """A kernel's int32 table operand: contiguous, 1-D, on the
    segments' device."""
    if t.dtype != torch.int32 or t.dim() != 1 or \
            not t.is_contiguous() or t.device != segments.device:
        raise ValueError(f"{what} must be a contiguous 1-D int32 "
                         f"tensor on the segments' device")


def load(source: str, lib_name: str, fn_name: str, argtypes: list,
         build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build if needed, load, and declare the launch function
    ``fn_name`` (returns an int: the CUDA error code, 0 on success)."""
    lib = ctypes.CDLL(build(source, lib_name, build_dir))
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
