"""The port stands alone: it imports neither JAX nor the JAX package,
its entry points default to CUDA and refuse to drop to the CPU, and the
kernel wrappers never fall back to the plain version for a CUDA
tensor."""

import ast
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import trivy_tpu_torch
from trivy_tpu_torch.ops import dfa_cuda, keywords_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "trivy_tpu_torch")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "trivy_tpu")


def _port_sources() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        out += [os.path.join(dirpath, n) for n in names
                if n.endswith(".py")]
    return sorted(out)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import trivy_tpu_torch\n"
        "for m in pkgutil.walk_packages(trivy_tpu_torch.__path__,\n"
        "                               'trivy_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'trivy_tpu'))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('trivy_tpu_torch.')]), bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    n, bad = proc.stdout.strip().split(" ", 1)
    assert bad == "[]"
    assert int(n) >= 90


# the sbom slice's modules: both checks above must reach them
SBOM_SLICE = ("types/common.py", "types/artifact.py", "types/report.py",
              "purl.py", "sbom/__init__.py", "sbom/cyclonedx.py",
              "sbom/spdx.py", "artifact/cache.py",
              "artifact/sbom.py", "applier.py", "detect/ospkg/drivers.py",
              "detect/enrich.py", "scan/post.py", "scan/local.py",
              "scan/filter.py", "report/writer.py", "cli.py")


# the fs slice's modules, in the subpackages it added
FS_SLICE = ("analyzer/__init__.py", "analyzer/analyzer.py",
            "analyzer/secret.py", "analyzer/os_release.py",
            "analyzer/apk.py", "analyzer/dpkg.py", "analyzer/rpm.py",
            "analyzer/language.py", "analyzer/jar.py",
            "analyzer/binary.py", "analyzer/pkgfiles.py",
            "analyzer/buildinfo.py", "analyzer/config.py",
            "analyzer/licensing.py", "rpmdb/__init__.py",
            "rpmdb/header.py", "rpmdb/bdb.py", "rpmdb/ndb.py",
            "rpmdb/sqlite.py", "handler/__init__.py", "handler/handler.py",
            "handler/gomod.py", "handler/sysfile.py",
            "handler/unpackaged.py", "utils/__init__.py",
            "utils/jsonloc.py", "misconf/__init__.py",
            "misconf/dockerfile.py", "artifact/walker.py",
            "artifact/artifact.py")


# the image slice's modules
IMAGE_SLICE = ("guard/__init__.py", "guard/budget.py", "guard/safetar.py",
               "artifact/__init__.py", "artifact/image.py",
               "artifact/walker.py", "artifact/cache.py",
               "artifact/artifact.py", "types/convert.py",
               "analyzer/imgconf.py", "scan/local.py", "cli.py")


# the fleet runtime's modules
RUNTIME_SLICE = ("runtime/__init__.py", "runtime/batch.py",
                 "runtime/ring.py", "runtime/hostpool.py",
                 "utils/__init__.py", "detect/batch.py",
                 "detect/metrics.py", "secret/batch.py",
                 "ops/resident.py", "artifact/artifact.py", "cli.py")


def _covered(modules) -> None:
    import importlib
    import pkgutil
    walked = {m.name for m in pkgutil.walk_packages(
        trivy_tpu_torch.__path__, "trivy_tpu_torch.")}
    sources = set(_port_sources())
    for rel in modules:
        assert os.path.join(PKG, rel) in sources, rel
        name = "trivy_tpu_torch." + rel[:-3].replace("/", ".") \
            .replace(".__init__", "")
        assert name in walked, name
        importlib.import_module(name)


def test_the_scans_cover_the_sbom_slice():
    _covered(SBOM_SLICE)


def test_the_scans_cover_the_fs_slice():
    _covered(FS_SLICE)


def test_the_scans_cover_the_image_slice():
    _covered(IMAGE_SLICE)


def test_the_scans_cover_the_runtime_slice():
    _covered(RUNTIME_SLICE)


def test_no_import_statement_names_jax_or_the_jax_package():
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            seen += 1
            for name in names:
                assert not _forbidden(name), (path, name)
    assert seen > 50
    assert not _forbidden("trivy_tpu_torch.ops")
    assert _forbidden("trivy_tpu.ops") and _forbidden("jax.numpy")


def _fake_cuda_segments():
    cuda = torch.device("cuda")
    seg = SimpleNamespace(device=cuda, dtype=torch.uint8,
                          shape=(32, 2048), dim=lambda: 2,
                          is_contiguous=lambda: True,
                          data_ptr=lambda: 4096)
    desc = SimpleNamespace(device=cuda, dtype=torch.int32,
                           dim=lambda: 1, is_contiguous=lambda: True,
                           numel=lambda: 8, data_ptr=lambda: 8192)
    return seg, desc


def test_cuda_tensor_without_a_kernel_raises(monkeypatch, tmp_path):
    """No toolkit here, so the kernel cannot be built: the wrapper must
    raise, not run the plain version."""
    from trivy_tpu_torch.ops.dfa import build_table

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(dfa_cuda, "dfa_masks_torch", plain)
    monkeypatch.setattr(dfa_cuda, "_lib", None)
    monkeypatch.setattr(dfa_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    table = build_table([b"imports-test-token"], [])
    seg, desc = _fake_cuda_segments()
    before = dfa_cuda.dfa_blockmask.launches
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        dfa_cuda.dfa_blockmask(seg, table, (desc,))
    assert dfa_cuda.dfa_blockmask.launches == before
    assert not os.listdir(tmp_path)


def test_wrapper_checks_its_inputs():
    from trivy_tpu_torch.ops.dfa import build_table
    table = build_table([b"imports-test-token"], [])
    seg, desc = _fake_cuda_segments()
    with pytest.raises(ValueError):
        dfa_cuda._check_cuda(SimpleNamespace(**{**vars(seg),
                                                "dtype": torch.int8}),
                             desc)
    with pytest.raises(ValueError):
        dfa_cuda._check_cuda(SimpleNamespace(**{**vars(seg),
                                                "shape": (32, 2000)}),
                             desc)
    with pytest.raises(ValueError):
        dfa_cuda._check_cuda(seg, SimpleNamespace(**{**vars(desc),
                                                     "dtype": torch.int64}))
    with pytest.raises(ValueError):
        dfa_cuda.dfa_blockmask(torch.zeros((32, 128), dtype=torch.uint8,
                                           device="meta"), table,
                               table.device_tables("cpu"))
    out, hits = dfa_cuda.dfa_blockmask(torch.from_numpy(
        np.zeros((4, 128), np.uint8)), table, table.device_tables("cpu"))
    assert out.shape == (4, 1) and not out.any()
    assert hits.shape == (4, 0)


def test_code_kernel_without_a_build_raises(monkeypatch, tmp_path):
    """The same for the literal-code kernel: raise, never the plain
    version, and build nothing."""
    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(keywords_cuda, "code_blockmask_torch", plain)
    monkeypatch.setattr(keywords_cuda, "_lib", None)
    monkeypatch.setattr(keywords_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    seg, codes = _fake_cuda_segments()
    before = keywords_cuda.code_blockmask.launches
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        keywords_cuda.code_blockmask(seg, codes)
    assert keywords_cuda.code_blockmask.launches == before
    assert not os.listdir(tmp_path)


def test_code_wrapper_checks_its_inputs():
    seg, codes = _fake_cuda_segments()
    keywords_cuda._check_cuda(seg, codes)
    for bad in ({"numel": lambda: 6}, {"numel": lambda: 0},
                {"dtype": torch.int64}, {"dim": lambda: 2},
                {"device": torch.device("cpu")}):
        with pytest.raises(ValueError):
            keywords_cuda._check_cuda(
                seg, SimpleNamespace(**{**vars(codes), **bad}))
    with pytest.raises(ValueError):
        keywords_cuda._check_cuda(
            SimpleNamespace(**{**vars(seg), "data_ptr": lambda: 4100}),
            codes)
    with pytest.raises(ValueError):
        keywords_cuda.code_blockmask(
            torch.zeros((32, 128), dtype=torch.uint8, device="meta"),
            torch.zeros(8, dtype=torch.int32, device="meta"))


def test_default_device_is_cuda_and_refuses_the_cpu(monkeypatch,
                                                    tmp_path):
    from trivy_tpu_torch.cli import main
    from trivy_tpu_torch.secret.batch import BatchSecretScanner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trivy_tpu_torch.DEFAULT_DEVICE == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trivy_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchSecretScanner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["fs", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["image", "--input", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["image", str(tmp_path), str(tmp_path), "--sched", "off"])
    from trivy_tpu_torch.runtime import BatchScanRunner
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchScanRunner()
    assert trivy_tpu_torch.resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no
    result; alone in a directory it cannot even start."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    for cwd in (REPO, str(tmp_path)):
        if cwd != REPO:
            (tmp_path / "chip_smoke.py").write_text(src)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
