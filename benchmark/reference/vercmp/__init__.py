"""A frozen copy of the port's version grammars
(``trivy_tpu_torch/vercmp``), kept here so that a change to the
program cannot change the reference that judges it.

Version grammars + constraint matching — the host side of the
package→CVE detector.

The reference delegates to one version-grammar module per ecosystem
(go.mod:14-18 + knqyf263/*; drivers in pkg/detector/library/driver.go
and pkg/detector/ospkg/*). Here each grammar parses versions into
totally-ordered comparison keys on the host; constraint expressions
compile into unions of half-open intervals over that order, which is
what the device interval match (``ops/intervals.py``) consumes.

Grammars: generic semver (aquasecurity/go-version semantics), apk,
deb, rpm, pep440, npm (node-semver), maven, rubygems.
"""

from .base import (ALWAYS, NEVER, Comparer, Interval, is_vulnerable)
from .registry import get_comparer

__all__ = ["Comparer", "Interval", "ALWAYS", "NEVER", "is_vulnerable",
           "get_comparer"]
