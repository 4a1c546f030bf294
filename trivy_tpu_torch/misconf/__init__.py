"""Misconfiguration scanning is still to be ported (ROADMAP A.9).
Only the Dockerfile parser is here, which the Red Hat buildinfo
analyzer reads (``analyzer/buildinfo.py``)."""
