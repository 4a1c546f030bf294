"""The port's interval match (``ops/intervals.py``, torch on the CPU)
against the reference's jitted functions run as JAX on the CPU and
against the numpy version, on seeded tables that cover all eight flag
combinations, unbounded sides, touching bounds and inert pad rows.
Every output is a bool per pair, so every comparison is equality."""

import numpy as np
import pytest
import torch

from trivy_tpu.ops import intervals as ref
from trivy_tpu_torch.ops import intervals as port

M = port.MAX_INTERVALS


def _tables(seed: int, P: int, pad: int = 0) -> tuple:
    """[P + pad] ranks and [P + pad, M] tables: each row has 0-M real
    intervals per side (some unbounded, some one point wide, ranks
    landing on bounds), every flag combination, and ``pad`` rows at
    the end as the dispatchers pack them (lo = POS_INF, hi = NEG_INF,
    flags 0)."""
    rng = np.random.default_rng(seed)
    n = P + pad
    rank = rng.integers(0, 64, n).astype(np.int32)
    tabs = []
    for _ in range(2):
        lo = np.full((n, M), port.POS_INF, np.int32)
        hi = np.full((n, M), port.NEG_INF, np.int32)
        for i in range(P):
            for j in range(int(rng.integers(0, M + 1))):
                a, b = sorted(int(x) for x in rng.integers(0, 64, 2))
                roll = rng.random()
                if roll < 0.1:
                    a = port.NEG_INF
                elif roll < 0.2:
                    b = port.POS_INF
                elif roll < 0.3:
                    b = a = int(rank[i])
                lo[i, j], hi[i, j] = a, b
        tabs += [lo, hi]
    flags = np.zeros(n, np.int32)
    flags[:P] = np.arange(P) % 8            # every combination of bits
    flags[:P] |= rng.integers(0, 4, P).astype(np.int32) << 3   # F_HOST..
    return (rank, *tabs, flags)


def _jax(fn, *arrs) -> np.ndarray:
    return np.asarray(fn(*arrs))


@pytest.mark.parametrize("seed,P,pad", [(1, 64, 0), (2, 200, 56),
                                        (3, 8, 56), (4, 1000, 24)])
def test_interval_hits_equals_reference(seed, P, pad):
    arrs = _tables(seed, P, pad)
    got = port.interval_hits(*(torch.from_numpy(a) for a in arrs))
    assert got.dtype == torch.bool and got.shape == (P + pad,)
    got = got.numpy()
    want = _jax(ref.interval_hits_impl, *arrs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.interval_hits_host(*arrs))
    np.testing.assert_array_equal(port.interval_hits_host(*arrs), want)
    assert not got[P:].any()                # pad rows never hit
    assert 0 < got[:P].sum() < P


def test_every_flag_combination_decides_as_specified():
    """One row per (flags, vuln hit, sec hit): the formula in the
    module docstring, written out."""
    rows = [(f, v, s) for f in range(8) for v in (0, 1) for s in (0, 1)]
    n = len(rows)
    rank = np.full(n, 10, np.int32)
    v_lo = np.full((n, M), port.POS_INF, np.int32)
    v_hi = np.full((n, M), port.NEG_INF, np.int32)
    s_lo, s_hi = v_lo.copy(), v_hi.copy()
    for i, (_, v, s) in enumerate(rows):
        v_lo[i, 1], v_hi[i, 1] = (9, 11) if v else (12, 20)
        s_lo[i, 3], s_hi[i, 3] = (10, 10) if s else (0, 9)
    flags = np.asarray([f for f, _, _ in rows], np.int32)
    arrs = (rank, v_lo, v_hi, s_lo, s_hi, flags)
    want = [bool(f & 2) or (bool(v) and not (f & 4 and s) if f & 1
                            else bool(f & 4) and not s)
            for f, v, s in rows]
    got = port.interval_hits(*(torch.from_numpy(a) for a in arrs)).numpy()
    assert got.tolist() == want
    np.testing.assert_array_equal(got, _jax(ref.interval_hits_impl, *arrs))


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("seed,N,P", [(5, 300, 512), (6, 40, 64),
                                      (7, 1000, 4096)])
def test_interval_hits_resident_equals_reference(seed, N, P, index_dtype):
    """A gather of candidate rows (repeats, pad rows, row 0 for pad
    slots as the dispatcher packs them) from resident tables."""
    rng = np.random.default_rng(seed)
    table = _tables(seed, N - 8, 8)
    rank = rng.integers(0, 64, P).astype(np.int32)
    row_idx = rng.integers(0, N, P).astype(np.int32)
    row_idx[-P // 8:] = 0
    rank[-P // 8:] = 0
    resident = tuple(torch.from_numpy(a.copy()) for a in table[1:])
    before = [t.clone() for t in resident]
    got = port.interval_hits_resident(
        torch.from_numpy(rank), torch.from_numpy(row_idx).to(index_dtype),
        *resident).numpy()
    want = _jax(ref.interval_hits_resident_impl, rank, row_idx, *table[1:])
    np.testing.assert_array_equal(got, want)
    gathered = [a[row_idx] for a in table[1:]]
    np.testing.assert_array_equal(
        got, ref.interval_hits_host(rank, *gathered))
    assert 0 < got.sum() < P
    for t, b in zip(resident, before):      # resident tables unwritten
        assert torch.equal(t, b)


def test_constants_match_reference():
    assert (port.MAX_INTERVALS, port.NEG_INF, port.POS_INF) == \
        (ref.MAX_INTERVALS, ref.NEG_INF, ref.POS_INF)
