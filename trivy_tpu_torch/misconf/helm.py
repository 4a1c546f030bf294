"""Helm chart rendering for misconfiguration scanning.

The reference renders charts through defsec's helm scanner with
value-file overrides (pkg/fanal/handler/misconf/
misconf.go:210-227 ScannerWithValuesFile/...WithValues). This module
implements a Go-template SUBSET sufficient to render typical chart
manifests into Kubernetes documents, which then flow through the same
Kubernetes policy set:

  - ``{{ .Values.a.b }}`` / ``{{ .Release.Name }}`` / ``{{ .Chart.Name
    }}`` value references (with ``-`` whitespace trimming)
  - ``|`` pipelines with ``default``, ``quote``, ``upper``, ``lower``
  - ``{{ if <ref> }} ... {{ else }} ... {{ end }}`` truthiness blocks
  - ``{{ include "..." . }}`` and other unsupported actions render
    empty (charts that depend on them still render their scalar
    fields, which is what the checks read)

Values precedence mirrors helm: chart values.yaml, then ``--helm-values``
files, then ``--set``-style string values — later wins.
"""

from __future__ import annotations

import posixpath
import re
from typing import Optional

try:
    import yaml as yaml_mod
except ImportError:          # pragma: no cover
    yaml_mod = None


def find_charts(paths: list) -> dict:
    """Group collected file paths into charts:
    {chart_root: [template paths]} for every directory holding a
    Chart.yaml with a templates/ subtree among ``paths``."""
    roots = {posixpath.dirname(p) for p in paths
             if posixpath.basename(p) == "Chart.yaml"}
    charts = {}
    for root in roots:
        tpl_prefix = posixpath.join(root, "templates") + "/"
        tpls = [p for p in paths if p.startswith(tpl_prefix)
                and p.endswith((".yaml", ".yml", ".tpl"))]
        if tpls:
            charts[root] = sorted(tpls)
    return charts


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def chart_values(files: dict, root: str,
                 value_overrides: Optional[list] = None,
                 set_values: Optional[list] = None) -> dict:
    """values.yaml + --helm-values files + --set pairs (later wins)."""
    values: dict = {}
    vpath = posixpath.join(root, "values.yaml")
    if vpath in files and yaml_mod is not None:
        try:
            v = yaml_mod.safe_load(
                files[vpath].decode("utf-8", "replace"))
            if isinstance(v, dict):
                values = v
        except yaml_mod.YAMLError:
            pass
    for content in value_overrides or []:
        try:
            v = yaml_mod.safe_load(content)
            if isinstance(v, dict):
                values = _deep_merge(values, v)
        except yaml_mod.YAMLError:
            pass
    for pair in set_values or []:
        if "=" not in pair:
            continue
        key, _, val = pair.partition("=")
        node = values = dict(values)
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            nxt = dict(nxt) if isinstance(nxt, dict) else {}
            node[p] = nxt
            node = nxt
        node[parts[-1]] = yaml_mod.safe_load(val) \
            if yaml_mod is not None else val
    return values


_ACTION_RE = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.DOTALL)
_TRIM_LEFT_RE = re.compile(r"[ \t]*\n?[ \t]*\{\{-")
_TRIM_RIGHT_RE = re.compile(r"-\}\}[ \t]*\n?")


def _lookup(ref: str, scope: dict):
    cur = scope
    for part in ref.split("."):
        if not part:
            continue
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def _eval_expr(expr: str, scope: dict):
    """One pipeline expression → value (None if unresolvable)."""
    stages = [s.strip() for s in expr.split("|")]
    head = stages[0]
    if head.startswith('"') and head.endswith('"'):
        val = head[1:-1]
    elif head.startswith("."):
        val = _lookup(head[1:], scope)
    elif re.fullmatch(r"-?\d+(\.\d+)?", head):
        val = float(head) if "." in head else int(head)
    elif head in ("true", "false"):
        val = head == "true"
    else:
        return None
    for stage in stages[1:]:
        parts = stage.split(None, 1)
        fn = parts[0]
        arg = parts[1].strip() if len(parts) > 1 else ""
        if fn == "default":
            if val in (None, "", False):
                val = _eval_expr(arg, scope)
        elif fn == "quote":
            val = f'"{val if val is not None else ""}"'
        elif fn == "upper" and isinstance(val, str):
            val = val.upper()
        elif fn == "lower" and isinstance(val, str):
            val = val.lower()
        elif fn in ("toYaml", "nindent", "indent", "trim"):
            # formatting helpers for nested structures are outside
            # the subset: drop the value rather than emit garbage
            if fn in ("nindent", "indent"):
                return None
    return val


def render(template: str, values: dict, release: str = "release",
           chart_name: str = "chart") -> str:
    """Render one template with the action subset. Unknown actions
    render as empty text."""
    scope = {
        "Values": values,
        "Release": {"Name": release, "Namespace": "default",
                    "Service": "Helm"},
        "Chart": {"Name": chart_name, "Version": "0.1.0"},
    }
    # normalize whitespace-trim markers so plain re substitution works
    text = _TRIM_LEFT_RE.sub("{{", template)
    text = _TRIM_RIGHT_RE.sub("}}", text)

    out = []
    pos = 0
    # if/else-if/else nesting: each frame tracks whether the current
    # branch emits and whether ANY branch of the chain has already
    # been taken (an else/else-if after a taken branch never emits)
    emit_stack = [{"emit": True, "done": True}]

    def _emitting():
        return all(f["emit"] for f in emit_stack)

    for m in _ACTION_RE.finditer(text):
        if _emitting():
            out.append(text[pos:m.start()])
        pos = m.end()
        action = m.group(1).strip()
        if action.startswith("if "):
            cond = bool(_eval_expr(action[3:].strip(), scope))
            emit_stack.append({"emit": cond, "done": cond})
        elif action.startswith("else if "):
            f = emit_stack[-1]
            if f["done"]:
                f["emit"] = False
            else:
                cond = bool(_eval_expr(action[8:].strip(), scope))
                f["emit"] = cond
                f["done"] = cond
        elif action == "else":
            f = emit_stack[-1]
            f["emit"] = not f["done"]
            f["done"] = True
        elif action == "end":
            if len(emit_stack) > 1:
                emit_stack.pop()
        elif action.startswith(("range ", "with ", "define ",
                                "include", "template", "/*")):
            # outside the subset: ranges/includes render empty; a
            # define..end swallows its body via the emit stack
            if action.startswith(("range ", "with ", "define ")):
                emit_stack.append({"emit": False, "done": True})
        else:
            if _emitting():
                v = _eval_expr(action, scope)
                if v is not None:
                    out.append(str(v))
    if _emitting():
        out.append(text[pos:])
    return "".join(out)


def render_chart(files: dict, root: str, tpl_paths: list,
                 value_overrides: Optional[list] = None,
                 set_values: Optional[list] = None) -> dict:
    """{template path: rendered text} for one chart."""
    values = chart_values(files, root, value_overrides, set_values)
    chart_name = posixpath.basename(root) or "chart"
    out = {}
    for p in tpl_paths:
        if p.endswith(".tpl"):
            continue        # helper definitions, not manifests
        src = files[p].decode("utf-8", "replace")
        out[p] = render(src, values, chart_name=chart_name)
    return out
