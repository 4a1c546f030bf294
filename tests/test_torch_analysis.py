"""The port's repo-invariant lint (``trivy_tpu_torch/analysis/``)
against the reference's (``trivy_tpu/analysis/``), ``pytest -m lint``.

Covers: the suppression grammar on seeded random comment lines (equal
parses) and its fail-closed findings; for each of the five shared
rules, violating and clean fixtures outside both packages (the
gauge-under-lock and pool-self-join shapes among them) with equal
findings and a byte-equal ``to_json()``; the scopes mapped onto
``trivy_tpu_torch/``; departure 1 (``hostpool-blocking`` sees a guard
one call away, and only a real thread-name check); departure 2
(``donation-safety`` retargeted at non-blocking copies, the real
``parallel/interval_shard.py`` clean and a planted mutant of it
flagged); the tree-wide gate on the port; and the CLI in a
subprocess."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_analysis import (PR4_FIXED, PR4_GAUGE_UNDER_LOCK,
                                 PR5_GUARDED, PR5_POOL_SELF_JOIN,
                                 TestLabelCardinality)
from trivy_tpu.analysis import analyze_source as ranalyze
from trivy_tpu.analysis import parse_suppressions as rparse
from trivy_tpu.analysis.engine import Engine as REngine
from trivy_tpu.analysis.rules import \
    HostpoolBlockingRule as RHostpoolRule
from trivy_tpu_torch.analysis import analyze_source as tanalyze
from trivy_tpu_torch.analysis import analyze_tree
from trivy_tpu_torch.analysis import parse_suppressions as tparse
from trivy_tpu_torch.analysis.engine import (UNUSED_SUPPRESSION,
                                             Engine, package_root)
from trivy_tpu_torch.analysis.rules import (HostpoolBlockingRule,
                                            default_rules)

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "trivy_tpu_torch")
SHARED = ("monotonic-clock", "lock-discipline", "hostpool-blocking",
          "bare-except-at-seam", "unbounded-label-cardinality")


def _key(rep) -> tuple:
    return ([(f.rule, f.path, f.line, f.message) for f in rep.findings],
            [(f.rule, f.path, f.line, f.message, f.reason)
             for f in rep.suppressed])


def _both(src, rel="fixture.py", extra=None):
    return (tanalyze(src, rel=rel, extra=extra),
            ranalyze(src, rel=rel, extra=extra))


def _rules_hit(rep, rule) -> list:
    return [f for f in rep.findings if f.rule == rule]


# ---------------------------------------------------------------
# the suppression grammar
# ---------------------------------------------------------------

def _random_comment(rng) -> str:
    rules = list(SHARED) + ["donation-safety", "no-such-rule", ""]
    words = ["leaf", "lock", "capped", "upstream", "wall", "--", "#",
             "label", "bounded", "fold", "disable=x", ",", " "]
    n = int(rng.integers(0, 4))
    chosen = [rules[int(i)] for i in rng.integers(0, len(rules), n)]
    sep = [",", ", ", " ,", ",,"][int(rng.integers(0, 4))]
    reason = " ".join(words[int(i)] for i in
                      rng.integers(0, len(words),
                                   int(rng.integers(0, 5))))
    head = ["# lint: disable=", "#lint:disable=", "#  lint:  disable=",
            "# lint disable=", "# lint: enable=", "# disable="][
        int(rng.integers(0, 6))]
    tail = ["", f" -- {reason}", f" --{reason}", f"  --  {reason}  ",
            " --"][int(rng.integers(0, 5))]
    prefix = ["", "x = 1  ", "    ", "s = '# lint: disable=a' "][
        int(rng.integers(0, 4))]
    return prefix + head + sep.join(chosen) + tail


def test_suppression_grammar_equals_the_reference_on_random_lines():
    """Seeded random comment lines, well formed or not, parse to the
    same suppressions (rules, reason, validity, line) in both."""
    rng = np.random.default_rng(20260804)
    parsed = 0
    for _ in range(40):
        lines = [_random_comment(rng) for _ in range(25)]
        t, r = tparse(lines), rparse(lines)
        assert sorted(t) == sorted(r), lines
        for ln in t:
            assert (t[ln].rules, t[ln].reason, t[ln].valid,
                    t[ln].line) == (r[ln].rules, r[ln].reason,
                                    r[ln].valid, r[ln].line)
        parsed += len(t)
    assert parsed > 200          # the property actually exercised


GRAMMAR = {
    "reasonless": ("try:\n    pass\n"
                   "# lint: disable=bare-except-at-seam\n"
                   "except:\n    pass\n"),
    "unknown-rule": "# lint: disable=no-such-rule -- because\nx = 1\n",
    "empty-rules": "# lint: disable=, -- because\nx = 1\n",
    "unused": "# lint: disable=monotonic-clock -- stale\nx = 1\n",
    "valid": ("import time\n"
              "# lint: disable=monotonic-clock -- test fixture\n"
              "d = time.time() - 0\n"),
    "block-above": ("import time\n"
                    "# lint: disable=monotonic-clock -- the reason\n"
                    "# continues in prose on following lines\n"
                    "d = time.time() - 0\n"),
    "trailing-no-leak": ("import time\n"
                         "x = 1  # lint: disable=monotonic-clock -- m\n"
                         "d = time.time() - 0\n"),
    "beyond-the-block": ("import time\n"
                         "# lint: disable=monotonic-clock -- far\n"
                         + "#\n" * 8 + "d = time.time() - 0\n"),
}


@pytest.mark.parametrize("name", sorted(GRAMMAR))
def test_suppression_findings_equal_the_reference(name):
    t, r = _both(GRAMMAR[name])
    assert _key(t) == _key(r)
    assert t.to_json() == r.to_json()


# ---------------------------------------------------------------
# the five shared rules: equal findings on the reference's fixtures
# ---------------------------------------------------------------

CROSS_A = ("import threading\n"
           "from other import locked_entry\n"
           "LOCK_A = threading.Lock()\n"
           "def caller():\n"
           "    with LOCK_A:\n"
           "        locked_entry()\n")
CROSS_B = ("import threading\n"
           "LOCK_B = threading.Lock()\n"
           "def locked_entry():\n"
           "    with LOCK_B:\n"
           "        return 1\n")
PKG_INIT = ("import threading\n"
            "from .queue import locked_entry\n"
            "INIT_LOCK = threading.Lock()\n"
            "def facade():\n"
            "    with INIT_LOCK:\n"
            "        locked_entry()\n")
PKG_QUEUE = ("import threading\n"
             "QLOCK = threading.Lock()\n"
             "def locked_entry():\n"
             "    with QLOCK:\n"
             "        return 1\n")
NEST = ("import threading\n"
        "A = threading.Lock()\n"
        "B = threading.Lock()\n"
        "def one():\n"
        "    with A:\n"
        "        with B:\n"
        "            pass\n"
        "def two():\n"
        "    with {0}:\n"
        "        with {1}:\n"
        "            pass\n")
METRIC_UNDER_CV = ("import threading\n"
                   "class Ring:\n"
                   "    def __init__(self, metrics):\n"
                   "        self._cv = threading.Condition()\n"
                   "        self.metrics = metrics\n"
                   "    def end(self):\n"
                   "        with self._cv:\n"
                   "            self.metrics.slot_end()\n")
NESTED_JOBS = ("from trivy_tpu.runtime.hostpool import "
               "get_host_pool, map_in_pool\n"
               "def parent_a(items):\n"
               "    def job(x):\n"
               "        return x\n"
               "    return map_in_pool(job, items)\n"
               "def parent_b(items):\n"
               "    def job(x):\n"
               "        pool = get_host_pool()\n"
               "        return pool.submit(str, x).result()\n"
               "    return map_in_pool(job, items)\n")
TRANSITIVE = ("from trivy_tpu.runtime.hostpool import "
              "get_host_pool, map_in_pool\n"
              "def leaf(x):\n"
              "    pool = get_host_pool()\n"
              "    return pool.submit(str, x).result()\n"
              "def middle(x):\n"
              "    return leaf(x)\n"
              "def outer(items):\n"
              "    return map_in_pool(middle, items)\n")
CAPPED = TestLabelCardinality.OPEN.replace(
    "            self._c[name] = self._c.get(name, 0) + 1\n",
    "            if name not in self._c and len(self._c) >= 64:\n"
    "                name = '<overflow>'\n"
    "            self._c[name] = self._c.get(name, 0) + 1\n")
TENANT = ("class CostBook:\n"
          "    def __init__(self):\n"
          "        self._t = {}\n"
          "    def charge(self, tenant, s):\n"
          "        self._t[tenant] = self._t.get(tenant, 0) + s\n"
          "    def snapshot(self):\n"
          "        if len(self._t) > 8:\n"
          "            return {'other': 0}\n"
          "        return dict(self._t)\n")

# (name, rule, violating?, {rel: source}); the first rel is the module
# analyzed, the rest ride along as ``extra``
SHARED_FIXTURES = [
    ("clock-sub", "monotonic-clock", True,
     {"fixture.py": "import time\nt0 = 0\nd = time.time() - t0\n"}),
    ("clock-aug", "monotonic-clock", True,
     {"fixture.py": "import time\nx = 0.0\nx += time.time()\n"}),
    ("clock-label", "monotonic-clock", False,
     {"fixture.py": "import time\nlabel = time.time()\n"
                    "d = {'wall': time.time()}\n"}),
    ("clock-mono", "monotonic-clock", False,
     {"fixture.py": "import time\nd = time.monotonic() - 0.5\n"}),
    ("pr4-gauge-under-lock", "lock-discipline", True,
     {"fixture.py": PR4_GAUGE_UNDER_LOCK}),
    ("pr4-fixed", "lock-discipline", False,
     {"fixture.py": PR4_FIXED}),
    ("metric-under-cv", "lock-discipline", True,
     {"fixture.py": METRIC_UNDER_CV}),
    ("cross-module-entry", "lock-discipline", True,
     {"fixture.py": CROSS_A, "other.py": CROSS_B}),
    ("package-init-import", "lock-discipline", True,
     {"fakepkg/__init__.py": PKG_INIT, "fakepkg/queue.py": PKG_QUEUE}),
    ("order-cycle", "lock-discipline", True,
     {"fixture.py": NEST.format("B", "A")}),
    ("consistent-nesting", "lock-discipline", False,
     {"fixture.py": NEST.format("A", "B")}),
    ("pr5-pool-self-join", "hostpool-blocking", True,
     {"fixture.py": PR5_POOL_SELF_JOIN}),
    ("pr5-guarded", "hostpool-blocking", False,
     {"fixture.py": PR5_GUARDED}),
    ("nested-jobs", "hostpool-blocking", True,
     {"fixture.py": NESTED_JOBS}),
    ("transitive", "hostpool-blocking", True,
     {"fixture.py": TRANSITIVE}),
    ("bare-except", "bare-except-at-seam", True,
     {"fixture.py": "try:\n    pass\nexcept:\n    pass\n"}),
    ("silent-swallow", "bare-except-at-seam", True,
     {"fixture.py": "try:\n    pass\nexcept Exception:\n    pass\n"}),
    ("logged", "bare-except-at-seam", False,
     {"fixture.py": "import logging\ntry:\n    pass\n"
                    "except Exception as e:\n"
                    "    logging.warning('boom %r', e)\n"}),
    ("narrow", "bare-except-at-seam", False,
     {"fixture.py": "try:\n    pass\nexcept ValueError:\n    pass\n"}),
    ("open-insert", "unbounded-label-cardinality", True,
     {"fixture.py": TestLabelCardinality.OPEN}),
    ("overflow-fold", "unbounded-label-cardinality", False,
     {"fixture.py": CAPPED}),
    ("tenant-fold-elsewhere", "unbounded-label-cardinality", True,
     {"fixture.py": TENANT}),
    ("preset-keys", "unbounded-label-cardinality", False,
     {"fixture.py": "class BarMetrics:\n"
                    "    def __init__(self):\n"
                    "        self._c = {'a': 0, 'b': 0}\n"
                    "    def inc(self, name):\n"
                    "        self._c[name] += 1\n"
                    "    def snapshot(self):\n"
                    "        return dict(self._c)\n"}),
]


@pytest.mark.parametrize("name,rule,violating,sources", SHARED_FIXTURES,
                         ids=[f[0] for f in SHARED_FIXTURES])
def test_shared_rule_findings_equal_the_reference(name, rule, violating,
                                                  sources):
    rels = list(sources)
    extra = {r: sources[r] for r in rels[1:]}
    t, r = _both(sources[rels[0]], rel=rels[0], extra=extra)
    assert _key(t) == _key(r)
    assert t.to_json() == r.to_json()
    assert bool(_rules_hit(t, rule)) == violating, t.text()


def test_multi_module_report_is_byte_equal():
    """Every shared fixture as one module set (fixture paths outside
    both packages): the whole reports are byte for byte the same."""
    sources: dict = {}
    for name, _rule, _v, srcs in SHARED_FIXTURES:
        for rel, src in srcs.items():
            sources[f"{name}/{rel}" if rel == "fixture.py" else rel] = src
    first, *rest = sorted(sources)
    extra = {k: sources[k] for k in rest}
    t, r = _both(sources[first], rel=first, extra=extra)
    assert t.to_json() == r.to_json()
    doc = json.loads(t.to_json())
    assert doc["files"] == len(sources)
    assert set(doc["counts"]) >= set(SHARED)


# ---------------------------------------------------------------
# scoping, mapped onto trivy_tpu_torch/
# ---------------------------------------------------------------

SEAM = "try:\n    pass\nexcept Exception:\n    pass\n"


@pytest.mark.parametrize("sub,at_seam", [
    ("rpc/x.py", True), ("watch/x.py", True), ("sched/x.py", True),
    ("runtime/x.py", True), ("artifact/x.py", True), ("memo/x.py", True),
    ("obs/x.py", True), ("guard/x.py", True), ("faults/x.py", True),
    ("parallel/x.py", True), ("router/x.py", True), ("impact/x.py", True),
    ("scan/x.py", True), ("types/x.py", False), ("detect/x.py", False),
    ("cli.py", False)])
def test_seam_scope_maps_onto_the_port(sub, at_seam):
    t = tanalyze(SEAM, rel=f"trivy_tpu_torch/{sub}")
    r = ranalyze(SEAM, rel=f"trivy_tpu/{sub}")
    tf = [(f.rule, f.line, f.message) for f in t.findings]
    rf = [(f.rule, f.line, f.message) for f in r.findings]
    assert tf == rf
    assert bool(tf) == at_seam
    # a bare except is flagged everywhere, in scope or not
    bare = "try:\n    pass\nexcept:\n    pass\n"
    assert _rules_hit(tanalyze(bare, rel=f"trivy_tpu_torch/{sub}"),
                      "bare-except-at-seam")


D2H_READ = ("import torch\n"
            "def fetch(hits):\n"
            "    out = torch.empty(hits.shape, pin_memory=True)\n"
            "    out.copy_(hits, non_blocking=True)\n"
            "    return out.numpy()\n")
JAX_DONATE = ("import jax\n"
              "def impl(a, b):\n"
              "    return a\n"
              "donated = jax.jit(impl, donate_argnums=(0,))\n"
              "def run(x, y):\n"
              "    out = donated(x, y)\n"
              "    return out + x.sum()\n")


@pytest.mark.parametrize("sub,port,ref", [
    ("ops/x.py", True, True), ("detect/x.py", True, True),
    ("runtime/ring.py", True, True), ("parallel/x.py", True, False),
    ("secret/batch.py", True, False), ("secret/scan.py", False, False),
    ("runtime/batch.py", False, False), ("sched/x.py", False, False)])
def test_donation_scope_maps_onto_the_port(sub, port, ref):
    """The port's rule is scoped to ``ops/``, ``detect/``,
    ``parallel/``, ``secret/batch.py`` and ``runtime/ring.py``; the
    reference's to the first two and the ring. Each rule's fixture,
    in and out of its scope."""
    t = tanalyze(D2H_READ, rel=f"trivy_tpu_torch/{sub}")
    r = ranalyze(JAX_DONATE, rel=f"trivy_tpu/{sub}")
    assert bool(_rules_hit(t, "donation-safety")) == port
    assert bool(_rules_hit(r, "donation-safety")) == ref
    # outside both packages every rule is in scope
    assert _rules_hit(tanalyze(D2H_READ), "donation-safety")


# ---------------------------------------------------------------
# departure 1: the guard may live one call away
# ---------------------------------------------------------------

POOL_TASK = """
def pack_segment(seg):
    if {test}:
        return [str(s) for s in seg]
    pool = get_host_pool()
    return list(pool.map(str, seg))

def sieve_enqueue(items):
    return map_in_pool(pack_segment, items)
"""
HEAD = ("import threading\n"
        "from trivy_tpu.runtime.hostpool import get_host_pool, "
        "map_in_pool\n")
PREFIX = 'PREFIX = "trivy-hostpool"\n'
CHECK_CONST = ("def on_pool_thread():\n"
               "    return threading.current_thread().name.startswith("
               "PREFIX)\n")
CHECK_LITERAL = ("def on_pool_thread():\n"
                 "    return threading.current_thread().name.startswith("
                 "'trivy-hostpool')\n")
CHECK_IN = ("def on_pool_thread():\n"
            "    return PREFIX in threading.current_thread().name\n")
NAMES_ONLY = ("def on_pool_thread():\n"
              "    return bool(PREFIX)\n")
OTHER_NAME = ("def on_pool_thread():\n"
              "    return threading.current_thread().name.startswith("
              "'ring-')\n")
TWO_LEVELS = CHECK_CONST + ("def on_worker():\n"
                            "    return on_pool_thread()\n")

GUARDS = [
    # (id, module source, helper module or None, guarded in the port)
    ("helper-with-constant", HEAD + PREFIX + CHECK_CONST, None, True),
    ("helper-with-literal", HEAD + CHECK_LITERAL, None, True),
    ("helper-comparing", HEAD + PREFIX + CHECK_IN, None, True),
    ("helper-imported", HEAD + "from helpers import on_pool_thread\n",
     "import threading\n" + PREFIX + CHECK_CONST, True),
    ("helper-names-only", HEAD + PREFIX + NAMES_ONLY, None, False),
    ("helper-other-thread", HEAD + OTHER_NAME, None, False),
    ("two-levels-away", HEAD + PREFIX + TWO_LEVELS, None, False),
]


@pytest.mark.parametrize("name,head,helper,guarded", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_guard_helper_departure(name, head, helper, guarded):
    """The reference flags every one of these (its guard must be a
    literal in the blocking function's own body); the port takes a
    callee that tests the thread name against the needle, one level
    deep, and nothing less."""
    test = "on_worker()" if name == "two-levels-away" \
        else "on_pool_thread()"
    src = head + POOL_TASK.format(test=test)
    extra = {"helpers.py": helper} if helper else None
    t, r = _both(src, extra=extra)
    assert len(_rules_hit(r, "hostpool-blocking")) == 1
    hit = _rules_hit(t, "hostpool-blocking")
    assert (not hit) == guarded, t.text()
    if hit:
        assert _key(t) == _key(r)


def test_the_reference_rule_flags_the_ports_map_in_pool():
    """Over the port's own tree the reference's rule reports
    ``map_in_pool`` (guarded by ``on_pool_thread()``) as a pool
    self-join; the port's rule does not."""
    base = package_root()
    paths = [p for p in Engine.tree_paths(PKG)]
    rmods = [REngine.load_module(p, base) for p in paths]
    tmods = [Engine.load_module(p, base) for p in paths]
    # (the other rules' suppressions name rules these engines lack)
    rhit = _rules_hit(REngine([RHostpoolRule()]).analyze(rmods),
                      "hostpool-blocking")
    thit = _rules_hit(Engine([HostpoolBlockingRule()]).analyze(tmods),
                      "hostpool-blocking")
    assert [(f.path, f.line) for f in rhit] == \
        [("trivy_tpu_torch/runtime/hostpool.py", 85)]
    assert "map_in_pool" in rhit[0].message
    assert thit == []


# ---------------------------------------------------------------
# departure 2: donation-safety on the port's non-blocking copies
# ---------------------------------------------------------------

def _d2h(after: str, before: str = "") -> str:
    return ("import numpy as np\nimport torch\n"
            "def fetch(hits, ev, stream, keep):\n"
            "    out = torch.empty(hits.shape, pin_memory=True)\n"
            + before +
            "    out.copy_(hits, non_blocking=True)\n"
            + after +
            "    return None\n")


def _h2d(after: str) -> str:
    return ("import torch\n"
            "def stage(slot, data, dev, ev, keep):\n"
            "    dev_t = slot.to(dev, non_blocking=True)\n"
            + after +
            "    return dev_t\n")


READS = ["    x = out.numpy()\n", "    x = out.tolist()\n",
         "    x = int(out)\n", "    x = np.asarray(out)\n",
         "    x = out + 1\n", "    x = out[0]\n", "    x = -out\n",
         "    x = out.shape\n", "    if out == 0:\n        pass\n"]
WRITES = ["    slot.copy_(data)\n", "    slot[:] = data\n",
          "    slot.zero_()\n", "    slot.fill_(0)\n",
          "    slot.numpy()[:] = data\n", "    slot[0] += 1\n"]


@pytest.mark.parametrize("read", READS)
def test_read_of_a_copy_destination_before_a_wait_is_flagged(read):
    hit = _rules_hit(tanalyze(_d2h(read)), "donation-safety")
    assert len(hit) == 1 and hit[0].line == 6
    assert "'out'" in hit[0].message and "line 5" in hit[0].message


@pytest.mark.parametrize("write", WRITES)
def test_write_to_an_upload_source_before_a_wait_is_flagged(write):
    hit = _rules_hit(tanalyze(_h2d(write)), "donation-safety")
    assert len(hit) == 1 and hit[0].line == 4
    assert "'slot'" in hit[0].message and "slot reuse" in hit[0].message


def test_read_after_x_to_is_flagged():
    src = ("def up(x, dev):\n"
           "    y = x.to(dev, non_blocking=True)\n"
           "    return y.sum()\n")
    assert _rules_hit(tanalyze(src), "donation-safety")


@pytest.mark.parametrize("wait", [
    "    ev.synchronize()\n", "    torch.cuda.synchronize()\n",
    "    stream.synchronize()\n",
    "    torch.cuda.current_stream().wait_event(ev)\n",
    "    torch.cuda.current_stream().wait_stream(stream)\n",
    "    ev.wait()\n", "    done_event.wait()\n"])
def test_waiting_first_is_clean(wait):
    assert not _rules_hit(tanalyze(_d2h(wait + READS[0])),
                          "donation-safety")
    assert not _rules_hit(tanalyze(_h2d(wait + WRITES[0])),
                          "donation-safety")


@pytest.mark.parametrize("after", [
    "    return out\n", "    keep(out)\n", "    keep(slots=[out])\n",
    "    x = {'out': out, 'bufs': (out, hits)}\n",
    "    keep(*[out])\n", "    x = out\n",
    "    lock.wait()\n    x = out.numpy()\n"])
def test_hand_off_or_other_wait_shapes(after):
    """A hand-off is no read; ``.wait()`` on something that is not an
    event or a stream (a lock, a barrier) is no wait."""
    flagged = "lock.wait()" in after
    assert bool(_rules_hit(tanalyze(_d2h(after)), "donation-safety")) \
        == flagged


def test_rebinding_ends_the_hazard():
    assert not _rules_hit(tanalyze(_d2h(
        "    out = None\n    x = out.numpy()\n")), "donation-safety")
    assert not _rules_hit(tanalyze(_h2d(
        "    slot = torch.empty(4)\n    slot.zero_()\n")),
        "donation-safety")


def test_loads_in_the_copys_own_argument_list_do_not_count():
    src = ("def fetch(out, hits):\n"
           "    out.copy_(\n"
           "        hits, non_blocking=out.is_pinned())\n"
           "    return out\n")
    assert not _rules_hit(tanalyze(src), "donation-safety")


def test_blocking_copies_are_not_tracked():
    for kw in ("", ", non_blocking=False"):
        src = ("def fetch(out, hits):\n"
               f"    out.copy_(hits{kw})\n"
               "    return out.numpy()\n")
        assert not _rules_hit(tanalyze(src), "donation-safety")


def test_the_references_donation_fixture_is_the_references_alone():
    """Nothing in the port calls ``jax.jit(..., donate_argnums=)``; the
    retargeted rule does not look for it."""
    assert _rules_hit(ranalyze(JAX_DONATE), "donation-safety")
    assert not _rules_hit(tanalyze(JAX_DONATE), "donation-safety")


INTERVAL_SHARD = "trivy_tpu_torch/parallel/interval_shard.py"
COPY_LINE = "    out.copy_(hits, non_blocking=True)\n"


def _interval_shard() -> str:
    with open(os.path.join(REPO, INTERVAL_SHARD)) as f:
        return f.read()


def test_interval_shard_stage_runs_clean():
    src = _interval_shard()
    assert COPY_LINE in src and "non_blocking=True)" in src
    assert tanalyze(src, rel=INTERVAL_SHARD).findings == []


def test_planted_interval_shard_mutant_is_flagged():
    """``_stage`` reading its pinned hits right after the non-blocking
    copy into them: flagged where the read sits."""
    src = _interval_shard()
    mutant = src.replace(COPY_LINE, COPY_LINE + "    out.numpy()\n")
    line = src[:src.index(COPY_LINE)].count("\n") + 2
    hit = _rules_hit(tanalyze(mutant, rel=INTERVAL_SHARD),
                     "donation-safety")
    assert [(f.path, f.line) for f in hit] == [(INTERVAL_SHARD, line)]
    assert f"line {line - 1}" in hit[0].message
    # out of the rule's scope the same mutant passes
    assert not _rules_hit(tanalyze(
        mutant, rel="trivy_tpu_torch/sched/interval_shard.py"),
        "donation-safety")


# ---------------------------------------------------------------
# the tree-wide gate
# ---------------------------------------------------------------

def _py_files(root: str) -> int:
    n = 0
    for dirpath, dirs, names in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")
                   and not d.startswith(".")]
        n += sum(name.endswith(".py") for name in names)
    return n


TRIAGED = {
    # the reference's reasoned suppressions, carried over
    ("trivy_tpu_torch/detect/metrics.py", "unbounded-label-cardinality"),
    ("trivy_tpu_torch/memo/metrics.py", "unbounded-label-cardinality"),
    ("trivy_tpu_torch/secret/metrics.py", "unbounded-label-cardinality"),
    ("trivy_tpu_torch/obs/profiler.py", "bare-except-at-seam"),
}


def test_the_build_directory_is_not_source(tmp_path):
    """Files under a ``_build`` directory (the kernels' libraries, the
    smoke run's work files) are never read; everything else is."""
    for rel in ("pkg/a.py", "pkg/_build/work/b.py", "pkg/sub/c.py",
                "pkg/__pycache__/d.py", "pkg/.hidden/e.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("x = 1\n")
    got = [os.path.relpath(p, tmp_path)
           for p in Engine.tree_paths(str(tmp_path / "pkg"))]
    assert got == ["pkg/a.py", "pkg/sub/c.py"]


def test_the_ports_tree_runs_clean():
    """``python -m trivy_tpu_torch.analysis`` ships clean: zero
    unsuppressed findings, no unused or reason-less suppression, every
    file of the package read, and the triaged findings suppressed
    with their reasons."""
    rep = analyze_tree()
    assert rep.ok, "\n" + rep.text()
    assert not [f for f in rep.findings if f.rule == UNUSED_SUPPRESSION]
    assert rep.files == _py_files(PKG) > 200
    assert all(f.reason.strip() for f in rep.suppressed)
    assert TRIAGED <= {(f.path, f.rule) for f in rep.suppressed}
    assert not [f for f in rep.suppressed
                if f.rule in ("hostpool-blocking", "donation-safety",
                              "monotonic-clock")]


# ---------------------------------------------------------------
# the CLI, in a subprocess
# ---------------------------------------------------------------

def _cli(pkg: str, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.analysis", *args], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_cli_list_rules_matches_the_reference():
    t, r = _cli("trivy_tpu_torch", "--list-rules"), \
        _cli("trivy_tpu", "--list-rules")
    assert t.returncode == r.returncode == 0
    tl = dict(line.split(": ", 1) for line in t.stdout.splitlines())
    rl = dict(line.split(": ", 1) for line in r.stdout.splitlines())
    assert sorted(tl) == sorted(rl) == sorted(
        SHARED + ("donation-safety",))
    assert all(tl[k] == rl[k] for k in SHARED)
    assert tl["donation-safety"] != rl["donation-safety"]
    assert tl["donation-safety"] == next(
        r.summary for r in default_rules() if r.name == "donation-safety")


def test_cli_json_is_byte_stable_and_clean():
    a, b = _cli("trivy_tpu_torch", "--json"), \
        _cli("trivy_tpu_torch", "--json")
    assert a.returncode == b.returncode == 0, a.stdout[-2000:]
    assert a.stdout == b.stdout
    doc = json.loads(a.stdout)
    assert doc["ok"] and doc["findings"] == []
    assert doc["files"] == _py_files(PKG)


def test_cli_unknown_rule_exits_2():
    p = _cli("trivy_tpu_torch", "--rules", "nope")
    assert p.returncode == 2
    assert "unknown rule(s): nope" in p.stderr


def test_cli_violation_prints_the_references_text(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nd = time.time() - 1\n"
                   "try:\n    pass\nexcept:\n    pass\n")
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    for path, rc in ((bad, 1), (ok, 0)):
        t, r = _cli("trivy_tpu_torch", str(path)), \
            _cli("trivy_tpu", str(path))
        assert t.returncode == r.returncode == rc
        assert t.stdout == r.stdout
    t = _cli("trivy_tpu_torch", str(bad), "--rules",
             "bare-except-at-seam")
    assert t.returncode == 1 and "monotonic-clock" not in t.stdout
    assert "bad.py:5: bare-except-at-seam:" in t.stdout
