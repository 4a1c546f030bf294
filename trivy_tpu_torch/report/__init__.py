"""Report writers (reference: pkg/report/writer.go:58-98).

Formats: json and cyclonedx. The others wait (ROADMAP A.9).
"""

from .writer import write_report

__all__ = ["write_report"]
