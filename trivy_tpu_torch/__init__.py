"""trivy_tpu_torch — the scan engine in PyTorch, for CUDA.

The secret-scan path (``python -m trivy_tpu_torch fs DIR``) runs its
multi-pattern sieve as a hand-written Hopper kernel
(``csrc/dfa_blockmask.cu``); the literal-code sieve
(``ops/keywords.py``) runs ``csrc/code_blockmask.cu``. The
vulnerability-detection engine (``vercmp``, ``db``, ``detect``)
matches installed versions against advisory interval tables kept on
the card (``ops/intervals.py``). Entry points run on ``cuda`` unless
the caller asks for ``cpu``; on the CPU every kernel is replaced by
its plain PyTorch version.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Asking for CUDA on a machine without it raises —
    a scan never drops to the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or "
            "--device cpu) to run the plain PyTorch path on the CPU")
    return dev


__all__ = ["DEFAULT_DEVICE", "resolve_device"]
