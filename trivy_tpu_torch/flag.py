"""Flag/config layer (reference: pkg/flag/options.go:19-92,
pkg/flag/global_flags.go; copied from ``trivy_tpu/flag.py``).

Precedence matches the reference's viper wiring: explicit CLI flag >
``TRIVY_<FLAG>`` environment variable > config file (``trivy.yaml``)
> built-in default. Env names are the flag name upper-cased with
dashes as underscores (options.go:154-156); config keys are the flag
names. ``--timeout`` mirrors global_flags.go:51-55 (5m default) and
aborts the scan when exceeded.

The port's own ``TRIVY_TPU_*`` variables (the dispatch depth, the
host pool, the pod topology) are not flags: no ``TRIVY_TPU_`` name is
ever read as the env binding of a flag. A config file that is there
but cannot be read — PyYAML missing included — ends the run with an
``error:`` line; it is never taken as absent.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import re
import signal
import sys

log = logging.getLogger("trivy_tpu_torch.flag")

ENV_PREFIX = "TRIVY_"
PORT_ENV_PREFIX = "TRIVY_TPU_"
DEFAULT_CONFIG_FILE = "trivy.yaml"

_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|h|m|s)")


def parse_duration(s) -> float:
    """Go-style duration ('5m0s', '1h30m', '300ms') or bare
    seconds → seconds."""
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    if s.replace(".", "", 1).isdigit():
        return float(s)
    total = 0.0
    pos = 0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise ValueError(f"invalid duration: {s!r}")
        value, unit = float(m.group(1)), m.group(2)
        total += value * {"h": 3600, "m": 60, "s": 1,
                          "ms": 0.001}[unit]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"invalid duration: {s!r}")
    return total


def import_yaml(path: str):
    """PyYAML, or an ``error:`` line and exit 2 naming the file that
    needs it."""
    try:
        import yaml
    except ImportError:
        print(f"error: cannot read config file {path}: PyYAML is not "
              "installed", file=sys.stderr)
        raise SystemExit(2)
    return yaml


def _config_path(argv) -> tuple:
    """(path, explicit) from a ``--config``/``-c`` pre-pass."""
    path = None
    for i, a in enumerate(argv):
        if a in ("--config", "-c") and i + 1 < len(argv):
            path = argv[i + 1]
        elif a.startswith("--config="):
            path = a.split("=", 1)[1]
        elif a.startswith("-c") and len(a) > 2 and \
                not a.startswith("--"):
            path = a[2:]
    return path or DEFAULT_CONFIG_FILE, path is not None


def _load_config_file(argv) -> dict:
    """--config <path> pre-pass; default trivy.yaml when present."""
    path, explicit = _config_path(argv)
    if not os.path.exists(path):
        if explicit:
            print(f"error: config file not found: {path}",
                  file=sys.stderr)
            raise SystemExit(2)
        return {}
    yaml = import_yaml(path)
    try:
        with open(path, encoding="utf-8") as f:
            doc = yaml.safe_load(f) or {}
    except (OSError, yaml.YAMLError) as e:
        print(f"error: failed to read config file {path}: {e}",
              file=sys.stderr)
        raise SystemExit(2)
    if not isinstance(doc, dict):
        return {}
    log.debug("loaded config file %s", path)
    return doc


def _convert(action, raw):
    """String from env/yaml → the action's value type."""
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction)):
        if isinstance(raw, bool):
            return raw
        return str(raw).strip().lower() in ("1", "true", "yes", "on")
    if isinstance(raw, list):
        raw = ",".join(str(x) for x in raw)
    value = action.type(raw) if action.type is not None else str(raw)
    if action.choices is not None and value not in action.choices:
        raise ValueError(
            f"{value!r} (choose from "
            f"{', '.join(map(str, action.choices))})")
    return value


def walk_parsers(parser):
    """``parser`` and every subcommand parser under it."""
    yield parser
    for action in parser._actions:
        choices = getattr(action, "choices", None)
        if isinstance(choices, dict):
            for sub in choices.values():
                if hasattr(sub, "_actions"):
                    yield from walk_parsers(sub)


def _command_parser(parser, argv):
    """The subcommand parser ``argv`` names (its first positional
    token, past the top level's ``--config FILE``), or None."""
    argv = list(argv or [])
    i = 0
    while i < len(argv):
        tok = argv[i]
        i += 1
        if tok in ("--config", "-c"):
            i += 1
        elif not tok.startswith("-"):
            for action in parser._actions:
                choices = getattr(action, "choices", None)
                if isinstance(choices, dict) and tok in choices:
                    return choices[tok]
            return None
    return None


def apply_external_defaults(parser, argv) -> None:
    """Rewrite parser defaults from env + config file so explicit CLI
    flags still win (viper's layering, options.go:140-162). A flag
    marked ``env_local`` takes its env/config value only when its own
    subcommand runs (``impact --timeout``, seconds, beside the scans'
    ``--timeout`` durations: one ``TRIVY_TIMEOUT`` fits only one)."""
    config = _load_config_file(argv or [])
    running = _command_parser(parser, argv)
    for p in walk_parsers(parser):
        for action in p._actions:
            if not action.option_strings:
                continue
            if getattr(action, "env_local", False) and p is not running:
                continue
            longs = [o for o in action.option_strings
                     if o.startswith("--")]
            if not longs:
                continue
            flag_name = longs[0][2:]
            if flag_name in ("help", "version", "config"):
                continue
            env_name = ENV_PREFIX + flag_name.upper()\
                .replace("-", "_")
            # the port's own TRIVY_TPU_* settings are never flags
            raw = None if env_name.startswith(PORT_ENV_PREFIX) \
                else os.environ.get(env_name)
            source = env_name
            if raw is None and flag_name in config:
                raw = config[flag_name]
                source = f"config key {flag_name!r}"
            if raw is None:
                continue
            try:
                action.default = _convert(action, raw)
            except (ValueError, TypeError) as e:
                print(f"error: invalid value for {source}: {e}",
                      file=sys.stderr)
                raise SystemExit(2)


class ScanTimeout(Exception):
    pass


@contextlib.contextmanager
def scan_deadline(seconds: float):
    """Abort the scan after ``seconds`` (ref --timeout applied at
    run.go:343). SIGALRM-based; no-op off the main thread or on
    platforms without setitimer."""
    if seconds <= 0 or not hasattr(signal, "setitimer"):
        yield
        return
    try:
        old = signal.signal(signal.SIGALRM, _raise_timeout)
    except ValueError:          # not in the main thread
        yield
        return
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _raise_timeout(signum, frame):
    raise ScanTimeout("scan timeout exceeded")
