"""Scan orchestration: applier → detectors → results → report.

Reference: pkg/scanner (scan.go) + pkg/scanner/local (scan.go:78-175).
"""

from .local import LocalScanner, ScanTarget
from .filter import filter_results

__all__ = ["LocalScanner", "ScanTarget", "filter_results"]
