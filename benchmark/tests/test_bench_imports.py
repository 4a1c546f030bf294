"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names (the
part before the first dot) are compared whole: the port's name begins
with the JAX package's."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "trivy_tpu"}
PROGRAM = "trivy_tpu_torch"


def _modules() -> list:
    out = []
    for d, _, files in os.walk(HERE):
        if "/." in d[len(HERE):]:
            continue
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                not node.args[0].value.startswith("."):
            names.add(node.args[0].value.split(".")[0])
    return names


MODULES = _modules()


def test_scan_finds_the_modules():
    rel = {os.path.relpath(p, HERE) for p in MODULES}
    assert {"run.py", "compare.py", "reference/vulns.py",
            "reference/vercmp/deb.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[os.path.relpath(p, HERE) for p in MODULES])
def test_no_jax_and_a_program_free_reference(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if os.path.relpath(path, HERE).startswith("reference" + os.sep):
        assert PROGRAM not in names, path


def test_the_comparison_is_whole_names():
    src = "import trivy_tpu_torch.cli\nfrom jaxlib import x\n" \
          "import jaxtyping\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tree_names.add(node.module.split(".")[0])
    assert tree_names & FORBIDDEN == {"jaxlib"}
