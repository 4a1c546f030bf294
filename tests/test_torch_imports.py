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


# the scheduler's modules (sched/ with the obs/ pieces it threads)
SCHED_SLICE = ("sched/__init__.py", "sched/queue.py",
               "sched/coalescer.py", "sched/metrics.py",
               "sched/tenant.py", "sched/scheduler.py",
               "obs/__init__.py", "obs/trace.py", "obs/recorder.py",
               "obs/cost.py", "obs/slo.py", "runtime/batch.py",
               "secret/batch.py", "cli.py")


# the mesh's modules (parallel/ with the routes that take a mesh)
PARALLEL_SLICE = ("parallel/__init__.py", "parallel/mesh.py",
                  "parallel/balance.py", "parallel/secret_shard.py",
                  "parallel/interval_shard.py", "parallel/multihost.py",
                  "parallel/simhost.py", "ops/resident.py", "ops/dfa.py",
                  "ops/keywords.py", "secret/batch.py", "detect/batch.py",
                  "runtime/batch.py", "sched/scheduler.py", "cli.py")


# the findings memo and the DB lifecycle, with the flag layer
MEMO_SLICE = ("memo/__init__.py", "memo/keys.py", "memo/store.py",
              "memo/findings.py", "memo/metrics.py", "db/delta.py",
              "detect/rematch.py", "db/compiled.py", "db/boltdb.py",
              "db/boltwriter.py", "db/lifecycle.py", "guard/safetar.py",
              "artifact/resilient.py", "flag.py", "utils/log.py",
              "scan/local.py", "runtime/batch.py", "sched/metrics.py",
              "cli.py")


# the observability device seams: obs/ with the modules that record
# its spans, events and metrics
OBS_SLICE = ("obs/__init__.py", "obs/trace.py", "obs/busy.py",
             "obs/timeline.py", "obs/profiler.py", "secret/metrics.py",
             "secret/batch.py", "parallel/secret_shard.py",
             "parallel/interval_shard.py", "parallel/simhost.py",
             "detect/batch.py", "ops/resident.py", "ops/dfa.py",
             "db/compiled.py", "runtime/ring.py", "runtime/batch.py",
             "scan/local.py", "artifact/artifact.py", "guard/budget.py",
             "memo/findings.py", "memo/store.py", "sched/metrics.py",
             "cli.py")


# the config and license checks: misconf/, licensing/, their analyzers,
# the misconf post-handler, and the modules that wire them in
CHECKS_SLICE = ("misconf/__init__.py", "misconf/policies.py",
                "misconf/hcl.py", "misconf/terraform.py",
                "misconf/cloudformation.py", "misconf/helm.py",
                "misconf/dockerfile.py", "licensing/__init__.py",
                "licensing/normalize.py", "licensing/corpus.py",
                "licensing/classifier.py", "analyzer/config.py",
                "analyzer/licensing.py", "handler/__init__.py",
                "handler/misconf.py", "scan/local.py",
                "artifact/artifact.py", "artifact/cache.py",
                "runtime/batch.py", "cli.py")


# the Rekor lookup, the report writers, and the scan server and its
# client with the modules they bring
SERVING_SLICE = ("rekor.py", "handler/unpackaged.py", "sbom/spdx.py",
                 "report/sarif.py", "report/github.py",
                 "report/template.py", "report/writer.py",
                 "utils/backoff.py", "types/convert.py",
                 "obs/propagate.py", "obs/procstats.py", "obs/prom.py",
                 "runtime/aot.py", "rpc/__init__.py", "rpc/server.py",
                 "rpc/client.py", "memo/warmth.py", "router/__init__.py",
                 "router/lifecycle.py", "watch/__init__.py",
                 "watch/metrics.py", "artifact/stream.py", "cli.py")


# scanning straight from a registry and the remote caches
REGISTRY_SLICE = ("artifact/registry.py", "artifact/localreg.py",
                  "artifact/stream.py", "artifact/resolve.py",
                  "artifact/redis_cache.py", "artifact/s3_cache.py",
                  "artifact/resilient.py", "artifact/artifact.py",
                  "memo/store.py", "guard/budget.py", "runtime/batch.py",
                  "cli.py")


# fault injection and continuous scanning
WATCH_SLICE = ("faults/__init__.py", "faults/spec.py", "faults/inject.py",
               "faults/hostile.py", "watch/__init__.py", "watch/source.py",
               "watch/loop.py", "watch/admission.py", "watch/metrics.py",
               "k8s/__init__.py", "utils/synth.py", "rpc/server.py",
               "artifact/resilient.py", "sched/metrics.py", "cli.py")

# the impact index, the prewarm and the federation plane
FLEET_SLICE = ("impact/__init__.py", "impact/index.py", "impact/metrics.py",
               "impact/push.py", "impact/federate.py", "router/__init__.py",
               "router/ring.py", "router/lifecycle.py", "memo/warmth.py",
               "memo/findings.py", "obs/federate.py", "obs/slo.py",
               "obs/cost.py", "obs/propagate.py", "parallel/simhost.py",
               "runtime/batch.py", "flag.py")

# the scan router in front of the card servers
ROUTER_SLICE = ("router/__init__.py", "router/metrics.py", "router/core.py",
                "router/front.py", "router/scaler.py", "router/sim.py",
                "router/ring.py", "router/lifecycle.py", "obs/prom.py",
                "faults/inject.py", "cli.py")

# the soak harness and the remaining subcommands (k8s with compliance,
# repo, module, plugin, aws, version)
SOAK_SLICE = ("soak/__init__.py", "soak/scenario.py", "soak/registry.py",
              "soak/audit.py", "soak/runner.py", "k8s/__init__.py",
              "k8s/report.py", "compliance.py", "artifact/remote.py",
              "module/__init__.py", "plugin/__init__.py",
              "cloud/__init__.py", "cli.py")

# the repo-invariant lint and the lock-order witness, and the CLI
# that installs the witness
ANALYSIS_SLICE = ("analysis/__init__.py", "analysis/__main__.py",
                  "analysis/engine.py", "analysis/rules.py",
                  "analysis/witness.py", "cli.py")


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


def test_the_scans_cover_the_sched_slice():
    _covered(SCHED_SLICE)


def test_the_scans_cover_the_parallel_slice():
    _covered(PARALLEL_SLICE)


def test_the_scans_cover_the_memo_slice():
    _covered(MEMO_SLICE)


def test_the_scans_cover_the_obs_slice():
    _covered(OBS_SLICE)


def test_the_scans_cover_the_checks_slice():
    _covered(CHECKS_SLICE)


def test_the_scans_cover_the_serving_slice():
    _covered(SERVING_SLICE)


def test_the_scans_cover_the_registry_slice():
    _covered(REGISTRY_SLICE)


def test_the_scans_cover_the_watch_slice():
    _covered(WATCH_SLICE)


def test_the_scans_cover_the_fleet_slice():
    _covered(FLEET_SLICE)


def test_the_scans_cover_the_router_slice():
    _covered(ROUTER_SLICE)


def test_the_scans_cover_the_soak_and_subcommands_slice():
    _covered(SOAK_SLICE)


def test_the_scans_cover_the_analysis_slice():
    _covered(ANALYSIS_SLICE)


def test_server_entry_runs_without_jax():
    """``python -m trivy_tpu_torch server`` parses its fleet flags (the
    peer list through ``obs/federate.py``), refuses ``--impact-index``
    without the memo (exit 2, as the reference) and exits, without
    loading JAX or the JAX package."""
    code = ("import sys\n"
            "from trivy_tpu_torch.cli import main\n"
            "rc = main(['server', '--backend', 'cpu', '--sched', 'off', "
            "'--no-memo', '--federate-peers', 'a=http://127.0.0.1:1', "
            "'--impact-index', '--prewarm-members', 'x'])\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'trivy_tpu'))\n"
            "print(rc, bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["2", "[]"]
    assert "error: --impact-index needs the findings memo (drop " \
        "--no-memo)" in proc.stderr


def test_simhost_entry_runs_without_jax():
    """``python -m trivy_tpu_torch.parallel.simhost`` starts and prints
    its usage (exit 2) without loading JAX or the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['simhost']\n"
            "try:\n"
            "    runpy.run_module('trivy_tpu_torch.parallel.simhost',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'trivy_tpu'))\n"
            "print(rc, bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["2", "[]"]
    assert "usage: python -m trivy_tpu_torch.parallel.simhost" in \
        proc.stderr


def test_router_sim_entry_runs_without_jax_or_torch():
    """``python -m trivy_tpu_torch.router.sim --port 0`` — the subprocess
    replica of the router's scaler — binds, prints ``PORT <n>`` and
    serves, without loading JAX, the JAX package or torch (its start-up
    is a fleet's bring-up time); the patched sleep stands in for the
    SIGINT that ends it."""
    code = ("import runpy, sys, time\n"
            "def stop(_s):\n"
            "    raise KeyboardInterrupt\n"
            "time.sleep = stop\n"
            "sys.argv = ['sim', '--port', '0', '--name', 'r9']\n"
            "try:\n"
            "    runpy.run_module('trivy_tpu_torch.router.sim',\n"
            "                     run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'trivy_tpu', 'torch'))\n"
            "print(rc, bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 2 and lines[0].startswith("PORT ")
    assert int(lines[0].split()[1]) > 0
    assert lines[1].split() == ["0", "[]"]


def test_subprocess_controller_spawns_the_ports_sim(monkeypatch):
    """``SubprocessReplicaController`` starts ``python -m
    trivy_tpu_torch.router.sim`` (the reference's spawns its own
    package's), reads its port and stops it."""
    from trivy_tpu_torch.router import scaler
    spawned = []
    real = subprocess.Popen

    def popen(argv, *a, **k):
        spawned.append(list(argv))
        return real(argv, *a, **k)

    monkeypatch.setattr(subprocess, "Popen", popen)
    ctrl = scaler.SubprocessReplicaController(prefix="imp")
    name, url = ctrl.start()
    try:
        assert name == "imp-0" and url.startswith("http://127.0.0.1:")
        assert spawned == [[sys.executable, "-m",
                            "trivy_tpu_torch.router.sim", "--name",
                            "imp-0", "--port", "0"]]
        proc = ctrl.procs[name]
        with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
            assert b"trivy_tpu_torch.router.sim" in f.read().split(b"\0")
    finally:
        ctrl.stop(name)
    assert proc.poll() is not None and not ctrl.procs


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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["image", str(tmp_path), str(tmp_path)])   # --sched on
    from trivy_tpu_torch.runtime import BatchScanRunner
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchScanRunner()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchScanRunner(sched="on")
    from trivy_tpu_torch.sched import ScanScheduler
    assert ScanScheduler().backend == "cuda"
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
