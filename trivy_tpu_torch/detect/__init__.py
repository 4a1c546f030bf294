"""Detectors: package lists × advisory store → DetectedVulnerability.

Reference: pkg/detector/library (ecosystem drivers). The comparison
work of a whole batch goes to the device in one dispatch through
``detect.batch``; the per-package host path (``LibraryDriver``) stays
for exactness checks and small scans.
"""

from .library import LibraryDriver, new_library_driver

__all__ = ["LibraryDriver", "new_library_driver"]
