"""trivy_tpu_torch — the scan engine in PyTorch, for CUDA.

The secret-scan path (``python -m trivy_tpu_torch fs DIR``) runs its
multi-pattern sieve as a hand-written Hopper kernel
(``csrc/dfa_blockmask.cu``); the literal-code sieve
(``ops/keywords.py``) runs ``csrc/code_blockmask.cu``. The
vulnerability-detection engine (``vercmp``, ``db``, ``detect``)
matches installed versions against advisory interval tables kept on
the card (``ops/intervals.py``); the ``image``, ``fs`` and ``sbom``
entries (``python -m trivy_tpu_torch image X.tar``, ``fs DIR``,
``sbom BOM``) drive both through the artifacts (``artifact/``, the
analyzers, the ingest guards of ``guard/``) and ``scan/local.py
LocalScanner``, and write the report. Entry points run
on ``cuda`` unless the caller asks for ``cpu``; on the CPU every
kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Asking for CUDA on a machine without it raises —
    a scan never drops to the CPU on its own. torch is imported here,
    not with the package: ``python -m trivy_tpu_torch.router.sim``
    (a subprocess replica) starts without it."""
    import torch
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass backend='cpu' (or "
            "--backend cpu) to run the plain PyTorch path on the CPU")
    return dev


__all__ = ["DEFAULT_DEVICE", "__version__", "resolve_device"]
