"""The ``license`` check of the port (``trivy_tpu_torch/licensing/``,
the license-file and dpkg copyright analyzers, ``LocalScanner``'s
license results) against the JAX package's, on the CPU.

``classify``, ``classify_findings``, ``is_human_readable`` and
``normalize`` on seeded texts made with numpy: every license text of
the corpus, whole and reflowed, fragments of them cut at seeded
points, SPDX headers and expressions, non-human-readable bytes; the
license-file analyzer's gate (names, extensions, skipped directories,
files over ``MAX_LICENSE_SIZE``); ``DpkgLicenseAnalyzer`` on seeded
``usr/share/doc/*/copyright`` files; ``LicenseScanner`` with the
default and with custom categories. Then ``fs``, ``image`` and the
fleet with ``--security-checks vuln,license``. Equality is exact: the
classifier's findings and the reports after ``sort_keys``."""

import contextlib
import importlib
import io
import json
import textwrap

import numpy as np
import pytest
import yaml

import trivy_tpu.analyzer.licensing as ralic
import trivy_tpu.db as rdb
import trivy_tpu.licensing as rlic
import trivy_tpu.licensing.classifier as rclass
import trivy_tpu.licensing.corpus as rcorpus
import trivy_tpu_torch.analyzer.licensing as talic
import trivy_tpu_torch.licensing as tlic
import trivy_tpu_torch.licensing.classifier as tclass
import trivy_tpu_torch.licensing.corpus as tcorpus
from chip_smoke import (FS_ROOTS, IMAGE_HISTORY, dpkg_names, fs_tree_files,
                        iac_files, make_advisory_store, make_corpus,
                        make_fs_tree, write_docker_save)
from tests.test_torch_scan_local import _fast_yaml, _fixture_docs
from tests.torch_threads import one_torch_thread  # noqa: F401
from trivy_tpu.cli import main as rmain
from trivy_tpu_torch.cli import main as tmain

# the packages' ``licensing`` re-export ``normalize``, which hides the
# module of that name from an ``import ... as``
rnorm = importlib.import_module("trivy_tpu.licensing.normalize")
tnorm = importlib.import_module("trivy_tpu_torch.licensing.normalize")
SEED = 20261016
STORE_ROWS = 2000
NAMES = sorted(rcorpus._CORPUS_TEXTS)


def _findings(mod, content: bytes) -> str:
    return json.dumps([f.to_dict() for f in mod.classify_findings(content)],
                      sort_keys=True)


def _classified(mod, path: str, content: bytes, full: bool) -> str:
    return json.dumps(mod.classify(path, content, full=full).to_dict(),
                      sort_keys=True)


def _license_text(name: str, rng, width: int = 0) -> str:
    body = "\n\n".join(tcorpus._CORPUS_TEXTS[name])
    if width:
        body = "\n".join("  " + line for line in textwrap.wrap(
            body, width))
    return f"Copyright (c) {int(rng.integers(1990, 2027))} Example\n\n" + body


def test_corpus_and_tables_equal_reference():
    assert tcorpus._CORPUS_TEXTS == rcorpus._CORPUS_TEXTS
    assert tnorm._MAPPING == rnorm._MAPPING
    assert tclass._PHRASES == rclass._PHRASES
    assert tlic.DEFAULT_CATEGORIES == rlic.DEFAULT_CATEGORIES
    assert talic.MAX_LICENSE_SIZE == ralic.MAX_LICENSE_SIZE


@pytest.mark.parametrize("name", NAMES)
def test_every_corpus_text_classifies_as_reference(name):
    """Each license text of the corpus, whole and reflowed at a seeded
    width, as a ``LICENSE`` file and as a source file's header, and
    its seeded fragments."""
    rng = np.random.default_rng(NAMES.index(name))
    texts = [_license_text(name, rng),
             _license_text(name, rng, int(rng.integers(30, 90)))]
    whole = texts[0]
    for _ in range(4):
        a, b = sorted(int(x) for x in rng.integers(0, len(whole), 2))
        texts.append(whole[a:b])
    for text in texts:
        data = text.encode()
        assert _findings(tclass, data) == _findings(rclass, data)
        for path, full in (("LICENSE", True), ("src/main.c", False)):
            assert _classified(tclass, path, data, full) == \
                _classified(rclass, path, data, full)
    got = {f.name for f in tclass.classify_findings(whole.encode())}
    assert name in got


def _spdx_header(rng) -> bytes:
    ids = ["MIT", "Apache-2.0", "GPL-2.0-only", "GPL-3.0-or-later",
           "BSD-3-Clause", "LGPL-2.1+", "MPL-2.0", "(MIT OR Apache-2.0)",
           "GPL-2.0 WITH Classpath-exception-2.0", "ISC AND BSD-2-Clause"]
    lead = ("// ", "# ", "/* ", "-- ", "")[int(rng.integers(0, 5))]
    expr = str(rng.choice(ids))
    if rng.integers(0, 3) == 0:
        expr += f" {rng.choice(['OR', 'AND', 'or'])} {rng.choice(ids)}"
    return f"{lead}SPDX-License-Identifier: {expr}\n".encode()


@pytest.mark.parametrize("seed", range(6))
def test_seeded_texts_classify_as_reference(seed):
    """Source files with SPDX headers, license phrases and prose, random
    bytes (human-readable or not) and text past the classifier's head
    size."""
    rng = np.random.default_rng(seed)
    words = ("the software is provided license permission granted "
             "redistribution copyright notice warranty gnu general public "
             "version apache mit bsd holder").split()
    for i in range(30):
        parts = []
        if rng.integers(0, 2):
            parts.append(_spdx_header(rng))
        prose = " ".join(rng.choice(words, int(rng.integers(5, 400))))
        parts.append(prose.encode())
        if rng.integers(0, 3) == 0:
            name = str(rng.choice(NAMES))
            parts.append(_license_text(name, rng).encode())
        if rng.integers(0, 4) == 0:
            parts.append(rng.bytes(int(rng.integers(1, 600))))
        if rng.integers(0, 4) == 0:
            parts.insert(0, b"x" * int(rng.integers(3000, 6000)))
        data = b"\n".join(parts)
        assert tclass.is_human_readable(data) == \
            rclass.is_human_readable(data)
        assert _findings(tclass, data) == _findings(rclass, data)
        path = f"src/f{i}" + str(rng.choice([".py", ".js", ".c", ".txt"]))
        for full in (False, True):
            assert _classified(tclass, path, data, full) == \
                _classified(rclass, path, data, full)


def test_normalize_equals_reference():
    rng = np.random.default_rng(3)
    names = list(rnorm._MAPPING) + NAMES
    names += [n.lower() for n in names] + [n.title() for n in names]
    names += [f"{n}{s}" for n in NAMES for s in ("-only", "-or-later",
                                                 "-ONLY", "+", "")]
    names += ["".join(rng.choice(list("GPLv23.+- ABCD"), 6))
              for _ in range(200)]
    for name in names:
        assert tlic.normalize(name) == rlic.normalize(name), name


@pytest.mark.parametrize("categories", [
    None, {"forbidden": ["MIT"]},
    {"notice": ["GPL-3.0"], "restricted": ["MIT", "Apache-2.0"],
     "unknown": ["BSD-3-Clause"]}])
def test_license_scanner_equals_reference(categories):
    names = NAMES + ["GPL-3.0-only", "GPLv2+", "Apache-2.0-or-later",
                     "MadeUp-1.0", "", "LGPL-2.1+"]
    rs, ts = rlic.LicenseScanner(categories), tlic.LicenseScanner(categories)
    for name in names:
        assert ts.scan(name) == rs.scan(name), name


def _analyze(mod, cls, path: str, content: bytes) -> str:
    return json.dumps(cls.analyze(path, content).to_blob_info().to_dict(),
                      sort_keys=True)


def test_license_file_analyzer_equals_reference():
    """The gate on seeded paths and sizes (names, extensions, the skip
    directories on segment boundaries, ``MAX_LICENSE_SIZE``) and what
    it finds."""
    rng = np.random.default_rng(4)
    dirs = ["", "app", "node_modules/x", "usr/share/doc/p", "usr/lib",
            "usr/libexec", "opt/yarn/lib", "src/usr/lib", "usr/src/app"]
    bases = ["LICENSE", "license.txt", "COPYING", "Copying.md", "NOTICE",
             "licence", "copyright", "main.py", "a.JS", "x.go", "README",
             "LICENSE.bin", "setup.cfg", "x.tsx", "y.vue"]
    r, t = ralic.LicenseFileAnalyzer(), talic.LicenseFileAnalyzer()
    for _ in range(300):
        path = "/".join(filter(None, [str(rng.choice(dirs)),
                                      str(rng.choice(bases))]))
        size = int(rng.choice([None, 10, talic.MAX_LICENSE_SIZE,
                               talic.MAX_LICENSE_SIZE + 1]) or 0) or None
        assert t.required(path, size) == r.required(path, size), path
    texts = [_license_text(n, rng).encode() for n in NAMES[:5]]
    texts += [b"\x00\x01binary " + texts[0], _spdx_header(rng) + b"x=1\n",
              b"plain text without a license\n"]
    for data in texts:
        for path in ("LICENSE", "pkg/COPYING", "src/app.py"):
            assert _analyze(talic, t, path, data) == \
                _analyze(ralic, r, path, data)


@pytest.mark.parametrize("seed", range(3))
def test_dpkg_license_analyzer_equals_reference(seed):
    """Seeded ``usr/share/doc/<pkg>/copyright`` files: machine-readable
    ``License:`` fields (lists with ``or``, ``and`` and commas),
    ``/usr/share/common-licenses`` references, free text, and paths the
    gate refuses."""
    rng = np.random.default_rng(seed)
    lics = ["GPL-2+", "MIT", "Apache-2.0", "LGPL-2.1+", "BSD-3-clause",
            "Zlib", "Artistic", "GPL-3+ with Bison exception", "public-domain"]
    r, t = ralic.DpkgLicenseAnalyzer(), talic.DpkgLicenseAnalyzer()
    for i in range(40):
        lines = ["Format: https://www.debian.org/doc/packaging-manuals/"
                 "copyright-format/1.0/", f"Upstream-Name: p{i}", ""]
        for _ in range(int(rng.integers(0, 4))):
            field = str(rng.choice(lics))
            for _ in range(int(rng.integers(0, 3))):
                field += str(rng.choice([" or ", " and ", ", ", " Or "])) \
                    + str(rng.choice(lics))
            lines += ["Files: *", f"License: {field}", ""]
        if rng.integers(0, 2):
            lines.append(f" /usr/share/common-licenses/"
                         f"{rng.choice(['GPL-2', 'GPL-3', 'LGPL-2.1'])}")
        if rng.integers(0, 3) == 0:
            lines.append("Some free-form copyright text.")
        data = "\n".join(lines).encode()
        for path in (f"usr/share/doc/p{i}/copyright",
                     f"usr/share/doc/p{i}/README", f"x/usr/share/doc/p{i}/"
                     "copyright"):
            assert t.required(path) == r.required(path)
            if r.required(path):
                assert _analyze(talic, t, path, data) == \
                    _analyze(ralic, r, path, data)


@pytest.mark.parametrize("categories", [{}, {"forbidden": ["MIT"],
                                             "notice": ["GPL-2.0"]}])
def test_local_scanner_license_results_equal_reference(categories):
    """``LocalScanner`` with the ``license`` check: OS package
    licenses, per-application licenses and loose files, each mapped to
    a category and severity, custom categories from
    ``ScanOptions.license_categories``."""
    from trivy_tpu.artifact import MemoryCache as RCache
    from trivy_tpu.scan.local import LocalScanner as RScanner
    from trivy_tpu.scan.local import ScanTarget as RTarget
    from trivy_tpu.types import (Application as RApp, BlobInfo as RBlob,
                                 LicenseFile as RLF,
                                 LicenseFinding as RLFi, OS as ROS,
                                 Package as RPkg, ScanOptions as ROpts)
    from trivy_tpu_torch.artifact import MemoryCache as TCache
    from trivy_tpu_torch.scan.local import LocalScanner as TScanner
    from trivy_tpu_torch.scan.local import ScanTarget as TTarget
    from trivy_tpu_torch.types import (Application as TApp,
                                       BlobInfo as TBlob,
                                       LicenseFile as TLF,
                                       LicenseFinding as TLFi, OS as TOS,
                                       Package as TPkg,
                                       ScanOptions as TOpts)
    out = []
    for cache, scanner, target, app, blob, lf, lfi, os_, pkg, opts in (
            (RCache(), RScanner, RTarget, RApp, RBlob, RLF, RLFi, ROS,
             RPkg, ROpts),
            (TCache(), TScanner, TTarget, TApp, TBlob, TLF, TLFi, TOS,
             TPkg, TOpts)):
        b = blob(
            os=os_(family="debian", name="12"),
            package_infos=[],
            applications=[app(type="npm", file_path="package-lock.json",
                              libraries=[pkg(name="a", version="1",
                                             licenses=["MIT"]),
                                         pkg(name="b", version="2",
                                             licenses=["GPL-2.0-only",
                                                       "Apache 2.0"])])],
            licenses=[lf(type="license-file", file_path="LICENSE",
                         findings=[lfi(name="MIT", confidence=0.9,
                                       link="https://x")]),
                      lf(type="header", file_path="src/a.py",
                         findings=[lfi(name="GPL-2.0", confidence=1.0)]),
                      lf(type="dpkg-license",
                         file_path="usr/share/doc/z/copyright",
                         pkg_name="z",
                         findings=[lfi(name="Zlib")])])
        cache.put_blob("sha256:b", b)
        sc = scanner(cache)
        prepared = sc.prepare(target("t", "sha256:a", ["sha256:b"]),
                              opts(security_checks=["license"],
                                   license_categories=categories))
        results, _ = sc.finish(prepared, [])
        out.append(json.dumps([r.to_dict() for r in results],
                              sort_keys=True))
    assert out[1] == out[0]
    assert [r["Class"] for r in json.loads(out[1])] == \
        ["license", "license", "license-file"]


# --- the entries ------------------------------------------------------

@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A seeded DB as fixture JSON, a debian tree with license files,
    source headers and a copyright file per dpkg package, the same as
    an image of layers, and a fleet of three such images."""
    d = tmp_path_factory.mktemp("license")
    store, n_pkgs = make_advisory_store(STORE_ROWS, SEED,
                                        store=rdb.AdvisoryStore())
    (d / "db.json").write_text(json.dumps(_fixture_docs(store)))
    corpus, _ = make_corpus(24, 7)
    rng = np.random.default_rng(SEED)
    headers = [(f"src/h{i}.py", _spdx_header(rng) + b"print(1)\n")
               for i in range(6)]
    os_files, app_files = fs_tree_files(FS_ROOTS["fs"], n_pkgs, SEED, 0.05)
    lic, _ = iac_files(SEED, dpkg_names(os_files), n_each=0, n_tf=0,
                       n_cfn_yaml=0, n_licenses=len(NAMES) + 2)
    tree = d / "tree"
    make_fs_tree(str(tree), FS_ROOTS["fs"], n_pkgs, SEED, 0.05,
                 files=corpus + headers + lic)
    big = tree / "big" / "LICENSE"
    big.parent.mkdir()
    big.write_bytes(b"MIT License\n" + b"x" * talic.MAX_LICENSE_SIZE)
    layers = [os_files, app_files + lic[:10], corpus + headers, lic[10:],
              [("iac/docker/svc0/.wh.LICENSE", b"")]]
    image = write_docker_save(str(d / "image.tar"), layers, IMAGE_HISTORY)
    # every image of the fleet holds the same copyright files: both
    # packages merge a dpkg license into the Package object of the
    # shared base layer's cached blob, where it stays for the next
    # image (ROADMAP Queue C), so images with copyright files of their
    # own would report what the scheduler's order leaves there
    copyrights = [x for x in lic if x[0].startswith("usr/share/doc/")]
    files = [x for x in lic if x not in copyrights]
    fleet = [write_docker_save(str(d / f"fleet{i}.tar"),
                               [os_files, app_files,
                                copyrights + files[i::3],
                                corpus[i * 8:(i + 1) * 8], []],
                               IMAGE_HISTORY, repo_tag=f"smoke/lic:{i}")
             for i in range(3)]
    return {"db": str(d / "db.json"), "tree": str(tree), "image": image,
            "fleet": fleet}


def _run(main, argv: list) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        code = main(argv)
    text = out.getvalue()
    return code, json.dumps(json.loads(text), sort_keys=True) \
        if text.lstrip().startswith(("{", "[")) else text


CASES = [
    ("fs", ["--format", "json"]),
    ("fs", ["--format", "table"]),
    ("rootfs", ["--format", "json", "--severity", "HIGH,CRITICAL",
                "--exit-code", "1"]),
    ("image", ["--format", "json"]),
    ("image", ["--format", "table", "--exit-code", "1"]),
    ("fleet-off", ["--format", "json"]),
    ("fleet-on", ["--format", "json", "--exit-code", "1"]),
]


@pytest.mark.parametrize("entry,flags", CASES)
def test_entries_equal_reference(seeded, entry, flags, tmp_path,
                                 monkeypatch):
    monkeypatch.setattr(yaml, "safe_load", _fast_yaml(yaml.safe_load))
    monkeypatch.chdir(tmp_path)
    if entry in ("fs", "rootfs"):
        argv = [entry, seeded["tree"]]
        extra = ["--no-cache"]
    elif entry == "image":
        argv = ["image", "--input", seeded["image"]]
        extra = ["--no-cache", "--no-memo"]
    else:
        argv = ["image", *seeded["fleet"], "--sched", entry[-3:].strip("-")]
        extra = ["--no-cache", "--no-memo"]
    argv += ["--security-checks", "vuln,license", "--db-fixtures",
             seeded["db"], "--backend", "cpu"] + flags
    want = _run(rmain, argv + extra)
    got = _run(tmain, argv)
    assert got == want
    assert want[0] == (1 if "--exit-code" in flags else 0)
    if "json" in flags and "--severity" not in flags:
        docs = json.loads(want[1])
        docs = docs if isinstance(docs, list) else [docs]
        for doc in docs:
            classes = {r["Class"] for r in doc["Results"]
                       if r.get("Licenses")}
            assert classes == {"license", "license-file"}
    if entry == "fs" and "json" in flags:
        paths = {lic.get("FilePath") for r in json.loads(got[1])["Results"]
                 for lic in r.get("Licenses", [])}
        assert "big/LICENSE" not in paths and "src/h0.py" in paths
