"""Custom-template writer — a Go text/template subset
(reference: pkg/report/template.go).

The reference renders user templates (contrib junit/gitlab/asff/html)
with go-template + sprig. This interpreter covers the constructs those
templates actually use: ``{{ .Field }}``, ``{{ range ... }}``,
``{{ if }}/{{ else }}/{{ end }}``, ``{{ len ... }}``, variable
bindings ``{{ $v := ... }}``, pipelines into the helper functions
(escapeXML, escapeString, endWithPeriod, toLower, upper, ...) and
``-`` whitespace trimming. Templates execute against the report's
Results list, exactly like the reference.
"""

from __future__ import annotations

import html
import json
import re
from typing import Any, Optional
from xml.sax.saxutils import escape as xml_escape

from ..types import Report

_TOKEN_RE = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.S)


def _go_name(py_obj: Any, name: str) -> Any:
    """Resolve Go-style .FieldName on dataclasses/dicts the way the
    JSON output names them."""
    if isinstance(py_obj, dict):
        return py_obj.get(name, "")
    d = getattr(py_obj, "to_dict", None)
    if d is not None:
        return py_obj.to_dict().get(name, "")
    return getattr(py_obj, name, "")


_FUNCS = {
    "escapeXML": lambda s: xml_escape(str(s)),
    "escapeString": lambda s: html.escape(str(s)),
    "endWithPeriod": lambda s: s if str(s).endswith(".")
    else str(s) + ".",
    "toLower": lambda s: str(s).lower(),
    "lower": lambda s: str(s).lower(),
    "toUpper": lambda s: str(s).upper(),
    "upper": lambda s: str(s).upper(),
    "len": lambda x: len(x) if x else 0,
    "sourceID": lambda s: s,
    "json": lambda x: json.dumps(x, default=str),
    "abbrev": lambda n, s: (str(s)[: int(n) - 3] + "...")
    if len(str(s)) > int(n) else str(s),
}


class _Node:
    pass


class _Text(_Node):
    def __init__(self, text):
        self.text = text


class _Action(_Node):
    def __init__(self, expr):
        self.expr = expr


class _Range(_Node):
    def __init__(self, expr, body, var=None, idx_var=None):
        self.expr, self.body = expr, body
        self.var, self.idx_var = var, idx_var


class _If(_Node):
    def __init__(self, expr, body, orelse):
        self.expr, self.body, self.orelse = expr, body, orelse


class _Assign(_Node):
    def __init__(self, var, expr):
        self.var, self.expr = var, expr


def _tokenize(src: str):
    """Yields text/action tokens with go-template `-` whitespace
    trimming already applied to the surrounding text."""
    tokens = []
    pos = 0
    for m in _TOKEN_RE.finditer(src):
        if m.start() > pos:
            tokens.append(["text", src[pos:m.start()]])
        raw = src[m.start():m.end()]
        text = m.group(1).strip()
        if raw.startswith("{{-") and tokens and \
                tokens[-1][0] == "text":
            tokens[-1][1] = tokens[-1][1].rstrip()
        tokens.append(("action", text, raw.endswith("-}}")))
        pos = m.end()
    if pos < len(src):
        tokens.append(["text", src[pos:]])
    for i, tok in enumerate(tokens):
        if tok[0] == "action" and tok[2] and \
                i + 1 < len(tokens) and tokens[i + 1][0] == "text":
            tokens[i + 1][1] = tokens[i + 1][1].lstrip()
    for tok in tokens:
        yield tuple(tok[:2]) if tok[0] == "text" else tok


def _parse(tokens, stop=("end",)):
    """Recursive-descent parse into a node list; returns
    (nodes, stop_word)."""
    nodes = []
    for tok in tokens:
        if tok[0] == "text":
            nodes.append(_Text(tok[1]))
            continue
        action = tok[1]
        word = action.split(None, 1)[0] if action else ""
        if word in stop:
            return nodes, word
        if word == "range":
            rest = action[len("range"):].strip()
            var = idx_var = None
            m = re.match(r"^\$(\w+)\s*,\s*\$(\w+)\s*:=\s*(.*)$", rest)
            if m:
                idx_var, var, rest = m.group(1), m.group(2), m.group(3)
            else:
                m = re.match(r"^\$(\w+)\s*:=\s*(.*)$", rest)
                if m:
                    var, rest = m.group(1), m.group(2)
            body, stop_word = _parse(tokens, stop=("end",))
            nodes.append(_Range(rest.strip(), body, var, idx_var))
        elif word == "if":
            expr = action[len("if"):].strip()
            body, stop_word = _parse(tokens, stop=("else", "end"))
            orelse = []
            if stop_word == "else":
                orelse, _ = _parse(tokens, stop=("end",))
            nodes.append(_If(expr, body, orelse))
        elif re.match(r"^\$(\w+)\s*:=", action):
            m = re.match(r"^\$(\w+)\s*:=\s*(.*)$", action, re.S)
            nodes.append(_Assign(m.group(1), m.group(2)))
        else:
            nodes.append(_Action(action))
    return nodes, None


class Template:
    def __init__(self, source: str):
        self.nodes, _ = _parse(iter(_tokenize(source)))

    # ---- evaluation --------------------------------------------------

    def _eval_atom(self, atom: str, dot, scope: dict):
        atom = atom.strip()
        if not atom or atom == ".":
            return dot
        if atom.startswith('"') and atom.endswith('"'):
            return atom[1:-1]
        if atom.lstrip("-").isdigit():
            return int(atom)
        if atom.startswith("$"):
            name, _, rest = atom[1:].partition(".")
            base = scope.get(name, "")
            return self._walk_fields(base, rest) if rest else base
        if atom.startswith("."):
            return self._walk_fields(dot, atom[1:])
        return atom

    def _walk_fields(self, base, dotted: str):
        cur = base
        for part in [p for p in dotted.split(".") if p]:
            if cur is None:
                return ""
            cur = _go_name(cur, part)
        return cur if cur is not None else ""

    def _eval(self, expr: str, dot, scope: dict):
        # pipelines: a | f | g
        parts = [p.strip() for p in _split_pipeline(expr)]
        value = self._eval_call(parts[0], dot, scope)
        for fn_expr in parts[1:]:
            bits = _split_args(fn_expr)
            fn = _FUNCS.get(bits[0])
            if fn is None:
                continue
            args = [self._eval_call(b, dot, scope)
                    for b in bits[1:]]
            value = fn(*args, value) if args else fn(value)
        return value

    def _eval_call(self, expr: str, dot, scope: dict):
        bits = _split_args(expr)
        if len(bits) > 1 and bits[0] in _FUNCS:
            args = [self._eval_call(b, dot, scope) for b in bits[1:]]
            return _FUNCS[bits[0]](*args)
        if len(bits) > 1 and bits[0] in ("eq", "ne", "lt", "gt"):
            a = self._eval_call(bits[1], dot, scope)
            b = self._eval_call(bits[2], dot, scope)
            return {"eq": a == b, "ne": a != b,
                    "lt": a < b, "gt": a > b}[bits[0]]
        if len(bits) > 1 and bits[0] in ("and", "or"):
            vals = [self._eval_call(b, dot, scope) for b in bits[1:]]
            if bits[0] == "and":
                result = vals[0]
                for v in vals[1:]:
                    if not result:
                        break
                    result = v
                return result
            for v in vals:
                if v:
                    return v
            return vals[-1]
        if bits[0] == "not" and len(bits) == 2:
            return not self._eval_call(bits[1], dot, scope)
        if expr.startswith("(") and expr.endswith(")"):
            return self._eval(expr[1:-1], dot, scope)
        return self._eval_atom(expr, dot, scope)

    def _render(self, nodes, dot, scope: dict, out: list):
        for node in nodes:
            if isinstance(node, _Text):
                out.append(node.text)
            elif isinstance(node, _Assign):
                scope[node.var] = self._eval(node.expr, dot, scope)
            elif isinstance(node, _Action):
                v = self._eval(node.expr, dot, scope)
                out.append("" if v is None else str(v))
            elif isinstance(node, _If):
                v = self._eval(node.expr, dot, scope)
                self._render(node.body if v else node.orelse,
                             dot, scope, out)
            elif isinstance(node, _Range):
                seq = self._eval(node.expr, dot, scope)
                for i, item in enumerate(seq or []):
                    inner = dict(scope)
                    if node.var:
                        inner[node.var] = item
                    if node.idx_var:
                        inner[node.idx_var] = i
                    self._render(node.body, item, inner, out)

    def render(self, dot) -> str:
        out: list = []
        self._render(self.nodes, dot, {}, out)
        return "".join(out)


def _split_pipeline(expr: str) -> list:
    parts, depth, buf, in_str = [], 0, [], False
    for ch in expr:
        if ch == '"':
            in_str = not in_str
        if not in_str:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "|" and depth == 0:
                parts.append("".join(buf))
                buf = []
                continue
        buf.append(ch)
    parts.append("".join(buf))
    return parts


def _split_args(expr: str) -> list:
    args, buf, depth, in_str = [], [], 0, False
    for ch in expr:
        if ch == '"':
            in_str = not in_str
            buf.append(ch)
            continue
        if not in_str and ch == "(":
            depth += 1
        elif not in_str and ch == ")":
            depth -= 1
        if not in_str and ch.isspace() and depth == 0:
            if buf:
                args.append("".join(buf))
                buf = []
            continue
        buf.append(ch)
    if buf:
        args.append("".join(buf))
    return args or [""]


class TemplateWriter:
    """--format template --template '<tpl or @file>'
    (template.go:30-80)."""

    def __init__(self, output, template_source: str):
        if not template_source:
            raise ValueError(
                "'--format template' requires '--template'")
        if template_source.startswith("@"):
            try:
                with open(template_source[1:]) as f:
                    template_source = f.read()
            except OSError as e:
                raise ValueError(
                    f"error retrieving template from path: {e}")
        self.output = output
        self.template = Template(template_source)

    def write(self, report: Report) -> None:
        self.output.write(
            self.template.render(
                [r.to_dict() for r in report.results]))
