"""The port's version grammars against the reference's, grammar by
grammar, on seeded versions and constraints: parse order, compare
sign, ``is_vulnerable``, and the intervals each constraint compiles
to (through ``_enc_key``, the persisted form of a key). Every answer
is exact, so every comparison is equality."""

import numpy as np
import pytest

from trivy_tpu.db.compiled import _enc_key as ref_enc
from trivy_tpu.vercmp import get_comparer as ref_comparer
from trivy_tpu.vercmp.base import is_vulnerable as ref_is_vulnerable
from trivy_tpu_torch.db.compiled import _enc_key as port_enc
from trivy_tpu_torch.vercmp import get_comparer as port_comparer
from trivy_tpu_torch.vercmp.base import is_vulnerable as port_is_vulnerable

GRAMMARS = ("semver", "npm", "pep440", "maven", "rubygems", "apk", "deb",
            "rpm")


def _pick(rng, seq):
    return seq[int(rng.integers(0, len(seq)))]


def _nums(rng, k: int = 3) -> str:
    return ".".join(str(int(rng.integers(0, 4))) for _ in range(k))


def _version(rng, grammar: str) -> str:
    n = _nums(rng, int(rng.integers(1, 5)))
    n3 = _nums(rng)
    if grammar == "semver":
        return _pick(rng, [n, n3, "v" + n3, f"{n3}-alpha.1", f"{n3}-rc.2",
                           f"{n3}-0", f"{n3}+build.7", f"{n3}-beta+b1",
                           "1.x", "not-a-version"])
    if grammar == "npm":
        return _pick(rng, [n3, n3, f"{n3}-beta.1", f"{n3}-rc.1", f"{n3}-0",
                           f"v{n3}", f"{n3}+b5", "1.2", "bad.version"])
    if grammar == "pep440":
        return _pick(rng, [n, n3, f"{n3}a1", f"{n3}b2", f"{n3}rc1",
                           f"{n3}.post1", f"{n3}.dev3", f"{n3}rc1.dev1",
                           f"1!{n3}", f"{n3}+local.7", f"{n3}-1", "x.y"])
    if grammar == "maven":
        return _pick(rng, [n, n3, f"{n3}-SNAPSHOT", f"{n3}-alpha-1",
                           f"{n3}.RELEASE", f"{n3}-rc1", f"{n3}-sp1",
                           f"{n3}.Final", f"{n3}-beta", f"{n3}-foo",
                           f"{n3}.0.0"])
    if grammar == "rubygems":
        return _pick(rng, [n, n3, f"{n3}.pre", f"{n3}-beta.1",
                           f"{n3}.rc1", f"{n3}.0", "", "1.2.a.3",
                           "bad version!"])
    if grammar == "apk":
        return _pick(rng, [f"{n3}-r{int(rng.integers(0, 5))}",
                           f"{n3}a-r1", f"{n3}_rc1-r0", f"{n3}_p2-r4",
                           f"{n3}_alpha_git3-r2", f"1.0{n3}-r0", n3,
                           "x-r1"])
    if grammar == "deb":
        return _pick(rng, [f"{n3}-{int(rng.integers(1, 4))}",
                           f"1:{n3}-1", f"{n3}-4ubuntu1", f"{n3}~rc1-1",
                           f"{n3}+dfsg-1", n3, f"{n3}-1~deb12u1",
                           "x:1.0-1", ""])
    return _pick(rng, [f"{n3}-{int(rng.integers(1, 4))}.el9", f"1:{n3}-1",
                       f"{n3}~rc1-1", f"{n3}^post1-1", f"{n3}a-1", n3,
                       f"{n3}-1.module+el9.1", ""])


def _constraint(rng, grammar: str) -> str:
    v = _version(rng, grammar)
    n3 = _nums(rng)
    n2 = _nums(rng, 2)
    if grammar in ("apk", "deb", "rpm"):
        return _pick(rng, [f"<{v}", v, f"< {v}"])
    if grammar == "semver":
        return _pick(rng, [f"<{n3}", f">={n2}, <{n3}", f"~> {n2}",
                           f"~{n3}", f"^{n3}", f"^0.{n2}", f"!={n3}",
                           "1.2.*", ">1.x", "<=2.*", "*", f"={v}",
                           f">= {n3} < 3", ">>1"])
    if grammar == "npm":
        return _pick(rng, [f"<{n3}", f"^{n3}", f"~{n2}", "1.2.x",
                           f">=1.0.0 <{n3}", f"{n2} - {n3}",
                           f">= 1.0.0, < {n3}", "*", f"<={n2}",
                           f">=1.0.0-rc.1 <{n3}", f"^0.0.{n3[-1]}",
                           f"> {v}", "1.x - 2", f"=={n3}"])
    if grammar == "pep440":
        return _pick(rng, [f"=={n2}.*", f"!={n2}.*", f"~={n2}",
                           f">={n2}, <{n3}", f"<{n3}", f"==={n3}", n3,
                           f"~=1", f">{v}", f"<={n3}rc1"])
    if grammar == "maven":
        return _pick(rng, [f"[{n2},{n3})", f"(,{n3}]", f"[{n3}]",
                           f">={n2}, <{n3}", f"< {n3}", f"!={n3}",
                           f"[{n2},)", f"({n2},{n3}),[3.0,)", "[", v])
    return _pick(rng, [f"~> {n2}", f"~> {n3}", f">= {n2}, < {n3}",
                       f"!= {n3}", f"= {n3}", n3, f"~> 1", f"> {v}",
                       "=> 1.0"])


def _cases(grammar: str, n: int, kind: str) -> list:
    rng = np.random.default_rng([ord(c) for c in grammar + kind])
    make = _version if kind == "version" else _constraint
    return [make(rng, grammar) for _ in range(n)]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError:
        return ("ValueError", None)


def _iv_enc(enc, ivs) -> list:
    return [(enc(iv.lo), iv.lo_incl, enc(iv.hi), iv.hi_incl) for iv in ivs]


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_parse_order_and_keys(grammar):
    """Versions parse (or fail) alike, sort into the same order, and
    their keys persist to the same tagged form and hash alike."""
    port, ref = port_comparer(grammar), ref_comparer(grammar)
    versions = sorted(set(_cases(grammar, 160, "version")))
    ok = []
    for v in versions:
        p, r = _outcome(port.parse, v), _outcome(ref.parse, v)
        assert p[0] == r[0], v
        if p[0] == "ok":
            assert port_enc(p[1]) == ref_enc(r[1]), v
            assert hash(p[1]) == hash(r[1]), v
            ok.append((v, p[1], r[1]))
    assert len(ok) >= 20
    by_port = [v for v, _, _ in sorted(ok, key=lambda t: t[1])]
    by_ref = [v for v, _, _ in sorted(ok, key=lambda t: t[2])]
    assert by_port == by_ref


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_compare_sign(grammar):
    port, ref = port_comparer(grammar), ref_comparer(grammar)
    versions = _cases(grammar, 48, "version")
    seen = set()
    for a in versions:
        for b in versions:
            p = _outcome(port.compare, a, b)
            assert p == _outcome(ref.compare, a, b), (a, b)
            seen.add(p[1])
    assert {-1, 0, 1} <= seen


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_constraint_intervals(grammar):
    """Each ||-free constraint compiles to the same interval union,
    bound for bound; a syntax error fails in both."""
    port, ref = port_comparer(grammar), ref_comparer(grammar)
    n_ok = 0
    for c in _cases(grammar, 200, "constraint"):
        p = _outcome(port.constraint_intervals, c)
        r = _outcome(ref.constraint_intervals, c)
        assert p[0] == r[0], c
        if p[0] == "ok":
            n_ok += 1
            assert _iv_enc(port_enc, p[1]) == _iv_enc(ref_enc, r[1]), c
    assert n_ok >= 50


@pytest.mark.parametrize("grammar", GRAMMARS)
def test_match_and_is_vulnerable(grammar):
    """``match`` over ||-joined constraints and ``is_vulnerable`` over
    vulnerable/patched/unaffected lists, empty strings included."""
    port, ref = port_comparer(grammar), ref_comparer(grammar)
    rng = np.random.default_rng([ord(c) for c in grammar] + [7])
    versions = _cases(grammar, 40, "version")
    cons = _cases(grammar, 60, "constraint")
    hits = 0
    for k in range(400):
        v = versions[k % len(versions)]
        vuln = [cons[int(i)] for i in rng.integers(0, len(cons),
                                                   int(rng.integers(0, 3)))]
        patched = [cons[int(i)] for i in rng.integers(0, len(cons),
                                                      int(rng.integers(0, 2)))]
        unaffected = [cons[int(i)] for i in rng.integers(
            0, len(cons), int(rng.integers(0, 2)))]
        if k % 37 == 0:
            vuln = vuln + [""]
        got = port_is_vulnerable(port, v, vuln, patched, unaffected)
        assert got == ref_is_vulnerable(ref, v, vuln, patched, unaffected), \
            (v, vuln, patched, unaffected)
        hits += got
        expr = " || ".join(vuln) if vuln else cons[k % len(cons)]
        assert _outcome(port.match, v, expr) == _outcome(ref.match, v, expr)
    assert 0 < hits < 400


@pytest.mark.parametrize("name", ["maven", "gradle", "npm", "yarn", "pip",
                                  "poetry", "rubygems", "bundler", "go",
                                  "cargo", "nuget", "apk", "deb", "rpm",
                                  "unknown-ecosystem", "Node.js"])
def test_registry_maps_names_alike(name):
    assert type(port_comparer(name)).__name__ == \
        type(ref_comparer(name)).__name__
    assert port_comparer(name).name == ref_comparer(name).name
