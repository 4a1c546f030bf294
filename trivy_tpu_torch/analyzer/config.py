"""IaC config-file collectors (reference:
pkg/fanal/analyzer/config/{dockerfile,yaml,json}): still to be ported
(ROADMAP A.9, with ``misconf/``). Only the analyzer type names are
here, which ``artifact._effective_disabled`` turns off."""

CONFIG_ANALYZER_TYPES = ("dockerfile", "yaml", "json", "terraform")
