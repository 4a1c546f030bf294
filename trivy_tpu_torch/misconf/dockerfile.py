"""Dockerfile instruction parser for policy evaluation.

Line-oriented with continuation handling, comment stripping, and
multi-stage tracking — the subset of buildkit's parser the built-in
checks need (reference: defsec's dockerfile parser feeding its
Go checks).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Instruction:
    cmd: str                  # upper-cased, e.g. "FROM", "USER"
    value: str                # raw argument string
    start_line: int = 0
    end_line: int = 0
    flags: list = field(default_factory=list)   # --flag=... args


@dataclass
class Stage:
    name: str                 # "AS" name or the base image ref
    base: str                 # base image ref
    alias: str = ""           # explicit "AS" name only
    instructions: list = field(default_factory=list)
    start_line: int = 0


def _take_token(s: str) -> tuple:
    """Split off the leading token, treating quoted spans as atomic —
    a flag value like ``--mount=type=secret,id="my id"`` must not
    leak its tail into the instruction value (buildkit's shell-word
    flag lexing)."""
    j, q = 0, ""
    while j < len(s):
        ch = s[j]
        if q:
            if ch == q:
                q = ""
        elif ch in "\"'":
            q = ch
        elif ch.isspace():
            break
        j += 1
    return s[:j], s[j:].strip()


def parse(content: bytes) -> list:
    """→ list[Stage]; a file with no FROM yields one anonymous
    stage so instruction-level checks still run."""
    stages: list = []
    cur: Stage = None
    lines = content.decode("utf-8", "replace").splitlines()

    i = 0
    while i < len(lines):
        raw = lines[i].strip()
        start = i + 1
        if not raw or raw.startswith("#"):
            i += 1
            continue
        # continuations; blank and comment lines inside a
        # continuation are skipped (buildkit accepts them)
        while raw.endswith("\\") and i + 1 < len(lines):
            i += 1
            nxt = lines[i].strip()
            if not nxt or nxt.startswith("#"):
                continue
            raw = raw[:-1].rstrip() + " " + nxt
        end = i + 1
        i += 1

        parts = raw.split(None, 1)
        cmd = parts[0].upper()
        rest = parts[1] if len(parts) > 1 else ""
        flags = []
        while rest.startswith("--"):
            flag, rest = _take_token(rest)
            flags.append(flag)
        inst = Instruction(cmd=cmd, value=rest, start_line=start,
                           end_line=end, flags=flags)

        if cmd == "FROM":
            tokens = rest.split()
            base = tokens[0] if tokens else ""
            name, alias = base, ""
            for j, t in enumerate(tokens):
                if t.upper() == "AS" and j + 1 < len(tokens):
                    name = alias = tokens[j + 1]
            cur = Stage(name=name, base=base, alias=alias,
                        start_line=start)
            stages.append(cur)
            continue
        if cur is None:
            cur = Stage(name="", base="", start_line=start)
            stages.append(cur)
        cur.instructions.append(inst)
    return stages
