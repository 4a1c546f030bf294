"""OS-package detectors (reference: pkg/detector/ospkg).

``ospkg_detect(family, os_ver, repo, pkgs, store)`` dispatches to the
distro driver (detect.go:30-45 family→driver map) and returns
(detected vulnerabilities, eosl flag).
"""

from .drivers import DRIVERS, ospkg_detect

__all__ = ["DRIVERS", "ospkg_detect"]
