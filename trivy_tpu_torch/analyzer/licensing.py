"""License analyzers (reference:
pkg/fanal/analyzer/licensing/license.go + analyzer/pkg/dpkg/
copyright.go): still to be ported (ROADMAP A.9, with ``licensing/``).
Only the analyzer type names are here, which
``artifact._effective_disabled`` turns off."""

LICENSE_ANALYZER_TYPES = ("license-file", "dpkg-license")
