"""The port's class-run detector (``trivy_tpu_torch.ops.runs``) against
the JAX package's NumPy reference and jitted body. Outputs are boolean,
so the comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from trivy_tpu.ops import runs as jruns
from trivy_tpu.secret.plan import build_scan_plan as j_build_plan
from trivy_tpu.secret.scanner import new_scanner as j_new_scanner
from trivy_tpu_torch.ops import runs as truns

B64 = frozenset(b"abcdefghijklmnopqrstuvwxyz"
                b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+/=")


def _specs(mod):
    return (mod.RunSpec.from_byteset(B64, 40),
            mod.RunSpec.from_byteset(frozenset(b"0123456789"), 12),
            mod.RunSpec.from_byteset(frozenset({0}), 1),
            mod.RunSpec.from_byteset(frozenset(range(128, 256)), 48),
            mod.RunSpec.from_byteset(frozenset(b" \t"), 5))


def _corpus(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (16, 512)).astype(np.uint8)
    buf[1, 100:140] = np.frombuffer(b"A1+/" * 10, np.uint8)
    buf[2, 512 - 40:] = np.frombuffer(b"z9=/" * 10, np.uint8)  # at L
    buf[3, 512 - 39:] = np.frombuffer(b"z9=/" * 10, np.uint8)[:39]
    buf[4, :12] = np.frombuffer(b"123456789012", np.uint8)
    buf[5, 200:248] = 200
    buf[6, 10:15] = np.frombuffer(b" \t \t ", np.uint8)
    buf[7, :] = 65
    return buf


def test_from_byteset_matches_reference():
    for a, b in zip(_specs(truns), _specs(jruns)):
        assert a.ranges == b.ranges and a.runlen == b.runlen


@pytest.mark.parametrize("seed", [0, 1])
def test_run_hits_vs_host_and_impl(seed):
    buf = _corpus(seed)
    want = jruns.run_hits_host(buf, _specs(jruns))
    impl = np.asarray(jruns.run_hits_impl(jnp.asarray(buf),
                                          _specs(jruns)))
    np.testing.assert_array_equal(impl, want)
    got = truns.run_hits(torch.from_numpy(buf), _specs(truns))
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[1, 0] and want[2, 0] and want[4, 1] and want[5, 3]


def test_builtin_plan_specs():
    specs = tuple(j_build_plan(j_new_scanner().rules).run_specs)
    assert sorted(s.runlen for s in specs) == [12, 16, 40]
    tspecs = tuple(truns.RunSpec(s.ranges, s.runlen) for s in specs)
    buf = _corpus(3)
    np.testing.assert_array_equal(
        truns.run_hits(torch.from_numpy(buf), tspecs).numpy(),
        jruns.run_hits_host(buf, specs))


def test_no_specs_is_an_empty_column_set():
    got = truns.run_hits(torch.zeros((3, 128), dtype=torch.uint8), ())
    assert got.shape == (3, 0) and got.dtype == torch.bool


@pytest.mark.parametrize("L", [128, 512])
def test_fused_wrapper_on_the_cpu_is_the_plain_pair(L):
    """``dfa_blockmask`` with run specs returns (masks, run hits); on
    the CPU those are the plain versions, and the hits equal the
    reference's for runs longer than 64 bytes and as long as L."""
    from trivy_tpu_torch.ops.dfa import build_table
    from trivy_tpu_torch.ops.dfa_cuda import dfa_blockmask, \
        dfa_masks_torch
    rng = np.random.default_rng(L)
    buf = rng.integers(0, 256, (8, L)).astype(np.uint8)
    buf[1, 20:120] = ord("k")
    buf[2, :] = ord("7")
    buf[3, L - 70:] = ord("x")
    sets = [(B64, 70), (frozenset(b"0123456789"), L),
            (frozenset(range(97, 123)), 100), (frozenset(b"k"), L + 1)]
    jspecs = tuple(jruns.RunSpec.from_byteset(b, n) for b, n in sets)
    tspecs = tuple(truns.RunSpec.from_byteset(b, n) for b, n in sets)
    table = build_table([b"ab"], [])
    seg = torch.from_numpy(buf)
    dev = table.device_tables("cpu")
    masks, hits = dfa_blockmask(seg, table, dev, tspecs)
    assert torch.equal(masks, dfa_masks_torch(seg, table, dev))
    want = jruns.run_hits_host(buf, jspecs)
    np.testing.assert_array_equal(hits.numpy(), want)
    assert want[1, 0] and want[2, 1] and want[3, 0] and not want[:, 3].any()
    masks_only, no_hits = dfa_blockmask(seg, table, dev)
    assert torch.equal(masks_only, masks) and no_hits.shape == (8, 0)
