"""HCL2 subset parser for Terraform misconfiguration scanning.

The reference evaluates Terraform through defsec's full HCL engine
(pkg/fanal/handler/misconf/misconf.go:19-29 pulls in
defsec's terraform scanner). This is a deliberately small re-design:
the policy checks (misconf.policies) need resource blocks, attribute
literals, and enough expression evaluation to resolve ``var.*``
defaults and ``local.*`` values — not a general Terraform interpreter.
Anything beyond the subset (function calls, arithmetic, for-
expressions, module references) evaluates to ``Unresolved``, which
checks treat as "unknown" and never fail on (defsec's checks behave
the same way on unresolvable values: they only flag provable
misconfigurations).

Grammar covered:
  block     = IDENT (STRING | IDENT)* "{" body "}"
  body      = (attribute | block)*
  attribute = IDENT "=" expr
  expr      = STRING (with ${...} interpolation) | HEREDOC | NUMBER
            | BOOL | NULL | list | map | reference | <unresolved>
Comments: ``#``, ``//``, ``/* */``. Heredocs: ``<<EOF`` / ``<<-EOF``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional


class Unresolved:
    """Value the subset evaluator cannot determine statically."""

    __slots__ = ("why",)

    def __init__(self, why: str = ""):
        self.why = why

    def __repr__(self):
        return f"Unresolved({self.why!r})"

    def __bool__(self):
        # unknowns are never treated as a provable misconfiguration
        return False

    def __eq__(self, other):
        return isinstance(other, Unresolved)

    def __hash__(self):
        return hash("<unresolved>")


@dataclass
class Attr:
    name: str
    value: object
    line: int = 0


@dataclass
class Block:
    type: str
    labels: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)     # name → Attr
    blocks: list = field(default_factory=list)    # nested Blocks
    start_line: int = 0
    end_line: int = 0

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        return a.value if a is not None else default

    def attr_line(self, name: str) -> int:
        a = self.attrs.get(name)
        return a.line if a is not None else self.start_line

    def find_blocks(self, btype: str) -> list:
        return [b for b in self.blocks if b.type == btype]

    def first_block(self, btype: str) -> Optional["Block"]:
        for b in self.blocks:
            if b.type == btype:
                return b
        return None


# ---------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*|//[^\n]*|/\*.*?\*/)
  | (?P<heredoc><<-?(?P<hd_tag>[A-Za-z_][A-Za-z0-9_]*)\n)
  | (?P<nl>\n)
  | (?P<string>"(?:\\.|\$\{[^}]*\}|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.*\-]*)
  | (?P<punct>[{}\[\]=,:()])
  | (?P<other>.)
""", re.VERBOSE | re.DOTALL)


@dataclass
class _Tok:
    kind: str
    text: str
    line: int


def _lex(src: str) -> list:
    toks = []
    line = 1
    pos = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if m is None:       # pragma: no cover - 'other' catches all
            break
        kind = m.lastgroup
        text = m.group()
        if kind == "heredoc":
            # consume lines until the terminator tag
            tag = m.group("hd_tag")
            body_start = m.end()
            term = re.compile(
                rf"^[ \t]*{re.escape(tag)}[ \t]*$", re.MULTILINE)
            tm = term.search(src, body_start)
            body_end = tm.start() if tm else n
            body = src[body_start:body_end]
            toks.append(_Tok("string_lit", body, line))
            # the terminator line's own newline is NOT consumed here
            # (pos stops at tm.end()); it is lexed next as an nl token,
            # so counting it here would double-shift later line numbers
            line += text.count("\n") + body.count("\n")
            pos = tm.end() if tm else n
            continue
        if kind == "nl":
            toks.append(_Tok("nl", "\n", line))
            line += 1
        elif kind == "comment":
            line += text.count("\n")
        elif kind not in ("ws",):
            toks.append(_Tok(kind, text, line))
        pos = m.end()
    return toks


# --------------------------------------------------------------- parser

_INTERP_RE = re.compile(r"\$\{([^}]*)\}")
_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}


class _Parser:
    def __init__(self, toks: list, ctx: dict):
        self.toks = [t for t in toks]
        self.i = 0
        self.ctx = ctx          # "var" → {name: value}, "local" → {...}

    def _peek(self, skip_nl=True) -> Optional[_Tok]:
        j = self.i
        while j < len(self.toks):
            t = self.toks[j]
            if skip_nl and t.kind == "nl":
                j += 1
                continue
            return t
        return None

    def _next(self, skip_nl=True) -> Optional[_Tok]:
        while self.i < len(self.toks):
            t = self.toks[self.i]
            self.i += 1
            if skip_nl and t.kind == "nl":
                continue
            return t
        return None

    def parse_body(self, top=False) -> tuple:
        """Returns (attrs dict, blocks list, end_line)."""
        attrs: dict = {}
        blocks: list = []
        end_line = 0
        while True:
            t = self._peek()
            if t is None:
                break
            if t.kind == "punct" and t.text == "}":
                self._next()
                end_line = t.line
                break
            if t.kind != "ident":
                self._next()        # skip stray token, stay robust
                continue
            name_tok = self._next()
            nxt = self._peek()
            if nxt is not None and nxt.kind == "punct" \
                    and nxt.text == "=":
                self._next()
                value = self.parse_expr()
                attrs[name_tok.text] = Attr(
                    name=name_tok.text, value=value,
                    line=name_tok.line)
                continue
            # block: labels then {
            labels = []
            while True:
                nxt = self._peek()
                if nxt is None:
                    break
                if nxt.kind == "string":
                    labels.append(_string_value(
                        self._next().text, self.ctx))
                    continue
                if nxt.kind == "ident":
                    labels.append(self._next().text)
                    continue
                break
            nxt = self._peek()
            if nxt is not None and nxt.kind == "punct" \
                    and nxt.text == "{":
                self._next()
                a, bl, end = self.parse_body()
                blocks.append(Block(
                    type=name_tok.text,
                    labels=[x if isinstance(x, str) else str(x)
                            for x in labels],
                    attrs=a, blocks=bl,
                    start_line=name_tok.line, end_line=end))
            # else: not a block — ignore (robustness)
        return attrs, blocks, end_line

    def parse_expr(self):
        t = self._next()
        if t is None:
            return Unresolved("eof")
        if t.kind == "string":
            return self._maybe_binop(_string_value(t.text, self.ctx))
        if t.kind == "string_lit":
            return _interp(t.text, self.ctx)
        if t.kind == "number":
            v = float(t.text) if "." in t.text else int(t.text)
            return self._maybe_binop(v)
        if t.kind == "ident":
            if t.text == "true":
                return self._maybe_binop(True)
            if t.text == "false":
                return self._maybe_binop(False)
            if t.text == "null":
                return self._maybe_binop(None)
            nxt = self._peek()
            if nxt is not None and nxt.kind == "punct" \
                    and nxt.text == "(":
                self._skip_parens()
                return Unresolved(f"call {t.text}()")
            if nxt is not None and nxt.kind == "punct" \
                    and nxt.text == "[":
                # index/splat expression: outside the subset
                self._skip_brackets()
                return Unresolved(f"index {t.text}[...]")
            return self._maybe_binop(
                _resolve_ref(t.text, self.ctx))
        if t.kind == "punct" and t.text == "[":
            out = []
            while True:
                nxt = self._peek()
                if nxt is None:
                    break
                if nxt.kind == "punct" and nxt.text == "]":
                    self._next()
                    break
                if nxt.kind == "punct" and nxt.text == ",":
                    self._next()
                    continue
                out.append(self.parse_expr())
            return out
        if t.kind == "punct" and t.text == "{":
            out = {}
            while True:
                nxt = self._peek()
                if nxt is None:
                    break
                if nxt.kind == "punct" and nxt.text == "}":
                    self._next()
                    break
                if nxt.kind == "punct" and nxt.text == ",":
                    self._next()
                    continue
                key_tok = self._next()
                key = key_tok.text
                if key_tok.kind == "string":
                    key = _string_value(key, self.ctx)
                sep = self._peek()
                if sep is not None and sep.kind == "punct" \
                        and sep.text in ("=", ":"):
                    self._next()
                    out[key] = self.parse_expr()
                else:
                    out[key] = Unresolved("bad map entry")
            return out
        return Unresolved(t.text)

    def _maybe_binop(self, value):
        """The subset doesn't evaluate operators — a trailing binary
        operator poisons the whole expression to Unresolved. After a
        complete value the only structural followers are newline, a
        closing brace/bracket/paren, a separator, or EOF; anything
        else ('+', '==' — whose first '=' lexes as punct —, '?', ...)
        starts an operator expression."""
        nxt = self._peek(skip_nl=False)
        if nxt is not None and (
                nxt.kind == "other"
                or (nxt.kind == "punct"
                    and nxt.text not in ("}", "]", ")", ",", ":"))):
            # consume the rest of the line
            while True:
                t = self._peek(skip_nl=False)
                if t is None or t.kind == "nl":
                    break
                self._next(skip_nl=False)
            return Unresolved("operator expression")
        return value

    def _skip_parens(self):
        self._skip_nested("(", ")")

    def _skip_brackets(self):
        self._skip_nested("[", "]")

    def _skip_nested(self, open_t: str, close_t: str):
        depth = 0
        while True:
            t = self._next()
            if t is None:
                return
            if t.kind == "punct" and t.text == open_t:
                depth += 1
            elif t.kind == "punct" and t.text == close_t:
                depth -= 1
                if depth == 0:
                    return


def _string_value(raw: str, ctx: dict):
    body = raw[1:-1]
    out = []
    i = 0
    n = len(body)
    while i < n:
        ch = body[i]
        if ch == "\\" and i + 1 < n:
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
            continue
        out.append(ch)
        i += 1
    return _interp("".join(out), ctx)


def _interp(s: str, ctx: dict):
    """Resolve ``${ref}`` interpolations; a non-literal part makes
    the whole string Unresolved ONLY if nothing else is known —
    partial resolution keeps the literal text with ``${...}`` left
    in place so prefix checks (e.g. image tags) still see shape."""
    def sub(m):
        v = _resolve_ref(m.group(1).strip(), ctx)
        if isinstance(v, Unresolved):
            return m.group(0)
        return str(v)
    return _INTERP_RE.sub(sub, s)


def _resolve_ref(ref: str, ctx: dict):
    parts = ref.split(".")
    if len(parts) >= 2 and parts[0] in ("var", "local"):
        scope = ctx.get(parts[0], {})
        v = scope.get(parts[1], Unresolved(ref))
        for p in parts[2:]:
            if isinstance(v, dict):
                v = v.get(p, Unresolved(ref))
            else:
                return Unresolved(ref)
        return v
    return Unresolved(ref)


# ----------------------------------------------------------- public API

def parse_file(src: str, ctx: Optional[dict] = None) -> list:
    """Parse one .tf file into top-level Blocks."""
    p = _Parser(_lex(src), ctx or {"var": {}, "local": {}})
    _attrs, blocks, _ = p.parse_body(top=True)
    return blocks


def parse_module(files: dict) -> list:
    """Parse a set of ``{path: source}`` .tf files as one module:
    pass 1 collects ``variable`` defaults and ``locals``, pass 2
    evaluates everything with those in scope (the defsec scanner
    evaluates a module directory the same way). Returns all top-level
    blocks across files, each annotated with ``src_path``."""
    ctx = {"var": {}, "local": {}}
    parsed0 = {p: parse_file(s) for p, s in files.items()}
    for blocks in parsed0.values():
        for b in blocks:
            if b.type == "variable" and b.labels:
                # no default (value supplied at plan/apply time) or an
                # explicit null means the value is UNKNOWN here — it
                # must never satisfy a provable-misconfiguration check
                v = b.attr("default")
                if "default" not in b.attrs or v is None:
                    v = Unresolved(f"var.{b.labels[0]}")
                ctx["var"][b.labels[0]] = v
            elif b.type == "locals":
                for name, attr in b.attrs.items():
                    ctx["local"][name] = attr.value
    out = []
    for path, src in files.items():
        for b in parse_file(src, ctx):
            b.src_path = path
            out.append(b)
    return out


def unresolved_trace(blocks: list) -> list:
    """Per-module evaluation visibility (the reference's rego
    --trace analog, pkg/flag/rego_flags.go:21-26): one line per
    attribute whose value the HCL subset could not evaluate, so a
    user can tell "no findings" apart from "couldn't evaluate".
    → [(src_path, "path:line block ref: attr = <unresolved: why>")]
    — structured so callers group by the real source path rather
    than re-splitting the display string (paths may contain
    colons)."""
    lines = []

    def walk_value(v, emit):
        if isinstance(v, Unresolved):
            emit(v.why)
        elif isinstance(v, list):
            for item in v:
                walk_value(item, emit)
        elif isinstance(v, dict):
            for item in v.values():
                walk_value(item, emit)

    def walk_block(b, src):
        ref = " ".join([b.type] + [f"{l!r}" for l in b.labels])
        for name, attr in b.attrs.items():
            walk_value(attr.value, lambda why, n=name, a=attr:
                       lines.append((src,
                                     f"{src}:{a.line} {ref}: {n} = "
                                     f"<unresolved: {why}>")))
        for nested in b.blocks:
            walk_block(nested, src)

    for b in blocks:
        walk_block(b, getattr(b, "src_path", ""))
    return lines
