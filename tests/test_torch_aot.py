"""The port's boot precompile (``runtime/aot.py``) against the
reference's on the CPU: the manifest's keys and the hit/miss split of a
cold and a warm boot on one directory, the metric names, the key's
invalidation domain, the inertness of zero inputs, and a kernel that
does not build failing the boot."""

import json
import os

import pytest
import torch

import trivy_tpu.runtime.aot as raot
import trivy_tpu_torch.runtime.aot as taot
from trivy_tpu_torch.ops import cuda_build, dfa_cuda, keywords_cuda
from trivy_tpu_torch.secret.batch import BatchSecretScanner

PAIRS = (64, 128)
SEGS = (8, 16)


@pytest.fixture(autouse=True)
def _fresh_metrics(monkeypatch):
    """Both singletons start from zero; the wrappers' build directories
    are restored after a boot pointed them at a test directory."""
    for mod in (dfa_cuda, keywords_cuda):
        monkeypatch.setattr(mod, "BUILD_DIR", mod.BUILD_DIR)
    taot.COMPILE_CACHE_METRICS.reset()
    raot.COMPILE_CACHE_METRICS.reset()
    yield
    taot.COMPILE_CACHE_METRICS.reset()
    raot.COMPILE_CACHE_METRICS.reset()


@pytest.fixture(scope="module")
def sieve():
    return BatchSecretScanner(backend="cpu")


def _manifest(d) -> dict:
    with open(os.path.join(d, taot.MANIFEST_NAME)) as f:
        return json.load(f)


@pytest.mark.parametrize("backend", ["cpu", "cpu-ref"])
def test_second_boot_is_only_hits(tmp_path, sieve, backend):
    d = str(tmp_path / "cc")
    cold = taot.boot_precompile(d, sieve.table, sieve.plan.run_specs,
                                pair_buckets=PAIRS, seg_buckets=SEGS,
                                backend=backend)
    n = len(PAIRS) + len(SEGS)
    assert (cold["misses"], cold["hits"]) == (n, 0)
    assert cold["build"] == {}              # the CPU builds no kernel
    assert [k["kernel"] for k in cold["kernels"]] == \
        ["interval_resident", "dfa_blockmask"]
    assert [k["shapes"] for k in cold["kernels"]] == [list(PAIRS),
                                                      list(SEGS)]
    entries = _manifest(d)
    assert len(entries) == n
    assert sorted(m["kernel"] for m in entries.values()) == \
        ["dfa_blockmask"] * 2 + ["interval_resident"] * 2
    assert {m["rules_hash"] for m in entries.values()
            if m["kernel"] == "dfa_blockmask"} == {sieve.table.rules_hash}
    warm = taot.boot_precompile(d, sieve.table, sieve.plan.run_specs,
                                pair_buckets=PAIRS, seg_buckets=SEGS,
                                backend=backend)
    assert (warm["misses"], warm["hits"]) == (0, n)
    assert set(_manifest(d)) == set(entries)
    snap = taot.COMPILE_CACHE_METRICS.snapshot()
    assert (snap["hits"], snap["misses"], snap["precompiled"]) == \
        (n, n, 2 * n)
    assert snap["dir"] == d and snap["bytes"] > 0


def test_split_and_metric_names_equal_reference(tmp_path):
    """The same ladder gives the reference's cold/warm split, and the
    ``compile_cache`` snapshot carries the reference's names."""
    for d in ("r", "t"):
        (tmp_path / d).mkdir()
    for boot in range(2):
        raot.precompile_interval_shapes(PAIRS, str(tmp_path / "r"))
        taot.precompile_interval_shapes(PAIRS, str(tmp_path / "t"),
                                        backend="cpu")
        want = raot.COMPILE_CACHE_METRICS.snapshot()
        got = taot.COMPILE_CACHE_METRICS.snapshot()
        assert set(got) == set(want)
        assert {k: got[k] for k in ("hits", "misses", "precompiled")} == \
            {k: want[k] for k in ("hits", "misses", "precompiled")}
    assert (got["hits"], got["misses"]) == (len(PAIRS), len(PAIRS))
    assert len(_manifest(str(tmp_path / "t"))) == \
        len(_manifest(str(tmp_path / "r")))


def test_key_is_the_invalidation_domain(monkeypatch):
    base = taot.cache_key("dfa_blockmask", "B8xL2048", "h1")
    assert len(base) == 32 and base == taot.cache_key(
        "dfa_blockmask", "B8xL2048", "h1")
    others = {taot.cache_key("dfa_blockmask", "B16xL2048", "h1"),
              taot.cache_key("dfa_blockmask", "B8xL2048", "h2"),
              taot.cache_key("interval_resident", "B8xL2048", "h1"),
              taot.cache_key("dfa_blockmask", "B8xL2048", "h1",
                             device=None)}
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    others.add(taot.cache_key("dfa_blockmask", "B8xL2048", "h1"))
    monkeypatch.undo()
    monkeypatch.setattr(torch.version, "cuda", "0.0")
    others.add(taot.cache_key("dfa_blockmask", "B8xL2048", "h1"))
    monkeypatch.undo()
    monkeypatch.setattr(taot, "_device_name", lambda d: "other card")
    others.add(taot.cache_key("dfa_blockmask", "B8xL2048", "h1"))
    assert base not in others and len(others) == 7


def test_zero_inputs_are_inert_or_the_boot_fails(tmp_path, sieve,
                                                 monkeypatch):
    """The warm launches run on zero inputs; the plain versions hit
    nothing there. A kernel whose zero input hits fails the boot."""
    from trivy_tpu_torch.ops import dfa
    seg = torch.zeros((8, 2048), dtype=torch.uint8)
    masks, hits = dfa.full_sieve(seg, sieve.table,
                                 sieve.table.device_tables("cpu"),
                                 tuple(sieve.plan.run_specs))
    assert not bool((masks.to(torch.int32) != 0).any())
    assert not bool(hits.any())
    monkeypatch.setattr(dfa, "full_sieve",
                        lambda s, *a: (torch.ones((s.shape[0], 1),
                                                  dtype=torch.int32),))
    with pytest.raises(RuntimeError, match="not inert"):
        taot.precompile_dfa_shapes(sieve.table, sieve.plan.run_specs,
                                   SEGS, str(tmp_path), backend="cpu")


def test_build_dir_and_build_failure(tmp_path, monkeypatch):
    """``enable_persistent_cache`` points the wrappers' build directory
    under the cache dir; on ``cuda`` a kernel that does not build fails
    the boot, and without a card the boot raises before any build."""
    d = str(tmp_path / "cc")
    build_dir = taot.enable_persistent_cache(d)
    assert build_dir == os.path.join(d, taot.KERNEL_DIR)
    assert os.path.isdir(build_dir)
    for mod in (dfa_cuda, keywords_cuda):
        if mod._lib is None:
            assert mod.BUILD_DIR == build_dir
        assert cuda_build.library_path(mod.SOURCE, "x", build_dir) \
            .startswith(build_dir)
    assert taot.enable_persistent_cache("") == ""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(cuda_build, "build",
                        lambda *a: built.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taot.boot_precompile(d, backend="cuda")
    assert built == []

    def no_nvcc(*args):
        raise RuntimeError("nvcc failed on dfa_blockmask")
    monkeypatch.setattr(cuda_build, "build", no_nvcc)
    monkeypatch.setattr(taot, "_torch_device",
                        lambda backend: torch.device("cpu"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        taot.boot_precompile(d, backend="cuda")


def test_unreadable_manifest_misses_cleanly(tmp_path):
    d = tmp_path / "cc"
    d.mkdir()
    (d / taot.MANIFEST_NAME).write_text("{not json")
    out = taot.precompile_interval_shapes(PAIRS, str(d), backend="cpu")
    assert out["shapes"] == list(PAIRS)
    snap = taot.COMPILE_CACHE_METRICS.snapshot()
    assert (snap["hits"], snap["misses"]) == (0, len(PAIRS))
    assert len(_manifest(str(d))) == len(PAIRS)
    # the numpy rung writes its own entries (another device name)
    taot.precompile_interval_shapes(PAIRS, str(d), backend="cpu-ref")
    assert len(_manifest(str(d))) == 2 * len(PAIRS)
