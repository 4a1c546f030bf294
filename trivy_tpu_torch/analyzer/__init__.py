"""Analyzer framework (reference: pkg/fanal/analyzer/analyzer.go).

Global registry + AnalyzerGroup: each analyzer declares ``required``
(path gating) and ``analyze`` (content → AnalysisResult fragment);
the group fans every file out to matching analyzers and merges results.
Analyzer versions feed cache keys (analyzer.go:89-106, 393-447).

Secret scanning is NOT per-file here — the group only *collects*
candidate files (gated like secret.go:112-), and the artifact layer
scans the whole collection in one batched sieve dispatch
(``secret/batch.py``).

The registration order below is the reference's: ``_merge_os`` and
``AnalysisResult.merge`` depend on it.
"""

from .analyzer import (AnalysisResult, Analyzer, AnalyzerGroup,
                       register_analyzer, registered_analyzers)
from . import os_release  # noqa: F401  (registration side effects)
from . import apk  # noqa: F401
from . import dpkg  # noqa: F401
from . import secret  # noqa: F401
from . import language  # noqa: F401
from . import rpm  # noqa: F401
from . import config  # noqa: F401
from . import licensing  # noqa: F401
from . import pkgfiles  # noqa: F401
from . import jar  # noqa: F401
from . import binary  # noqa: F401
from . import buildinfo  # noqa: F401

__all__ = ["Analyzer", "AnalysisResult", "AnalyzerGroup",
           "register_analyzer", "registered_analyzers"]
