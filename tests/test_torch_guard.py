"""The port's ingest guards (``trivy_tpu_torch/guard``) and layer walk
(``artifact/walker.py::collect_layer_tar``) against the JAX package's
on the same inputs: each case of tests/test_hostile.py's
``TestWalkerPaths`` and ``TestBudgetPrimitives`` runs through both
packages and must end the same way (the same result, or the same
exception class and message), and still as that test expects. The
scheduler-metrics case of ``TestBudgetPrimitives`` runs on each
package's own ``ScanScheduler``, beside a case on the counters
themselves."""

import dataclasses
import gzip
import io
import tarfile
import time

import pytest

import trivy_tpu.artifact.walker as rwalker
import trivy_tpu.guard as rguard
import trivy_tpu.guard.budget as rbudget
import trivy_tpu.guard.safetar as rsafetar
import trivy_tpu_torch.artifact.walker as twalker
import trivy_tpu_torch.guard as tguard
import trivy_tpu_torch.guard.budget as tbudget
import trivy_tpu_torch.guard.safetar as tsafetar

PKGS = {"ref": (rguard, rbudget, rsafetar, rwalker),
        "port": (tguard, tbudget, tsafetar, twalker)}


def _outcome(fn):
    """What ``fn()`` ends with: ("ok", value) or (exception class name,
    message)."""
    try:
        return "ok", fn()
    except Exception as e:          # noqa: BLE001 - compared, not hidden
        return type(e).__name__, str(e)


def _both(fn) -> tuple:
    """``fn(guard, budget, safetar, walker)`` on each package; both must
    end the same way. Returns that outcome."""
    got = {k: _outcome(lambda m=m: fn(*m)) for k, m in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["ref"]


# --- the layer walk (TestWalkerPaths) -----------------------------------

def _tar(names, sizes=None, links=()) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name in names:
            ti = tarfile.TarInfo(name)
            ti.size = (sizes or {}).get(name, 0)
            tf.addfile(ti, io.BytesIO(b"x" * ti.size))
        for name, target, kind in links:
            ti = tarfile.TarInfo(name)
            ti.type = kind
            ti.linkname = target
            tf.addfile(ti)
    return buf.getvalue()


def _walk(data: bytes, limits=None):
    """``fn`` for ``_both``: walk ``data`` under a budget of ``limits``
    (a dict of ``ResourceLimits`` fields; None walks unguarded)."""
    def run(guard, budget, safetar, walker):
        b = None if limits is None else \
            guard.ResourceBudget(guard.ResourceLimits(**limits))
        with tarfile.open(fileobj=io.BytesIO(data)) as tf:
            files, opq, wh = walker.collect_layer_tar(tf, budget=b)
            out = ([(p, s, r()) for p, s, r in files], opq, wh)
        return out, None if b is None else (b.entries, b.soft_faults)
    return run


WALK_CASES = {
    # name: (names, sizes, links, limits, expected paths or (exc, match))
    "benign_names_normalized": (
        ["./.env", "./app/x", "/abs/file", "plain.txt", "a/./b"], None,
        (), None, [".env", "app/x", "abs/file", "plain.txt", "a/b"]),
    "traversal_skipped_unguarded": (
        ["../../etc/passwd", "a/../../b", "ok.txt"], None, (), None,
        ["ok.txt"]),
    "traversal_trips_guarded": (
        ["../../etc/passwd"], None, (), {},
        ("MalformedArchiveError", "traversal")),
    "inner_dotdot_normalizes_in_bounds": (
        ["a/b/../c"], None, (), None, ["a/c"]),
    "whiteout_traversal_skipped_unguarded": (
        ["app/.wh.x", "app/.wh...", "dir/.wh..wh..opq"], None, (), None,
        []),
    "whiteout_traversal_trips_guarded": (
        ["app/.wh..."], None, (), {}, ("MalformedArchiveError",
                                       "whiteout")),
    "one_char_component_depth_attack_still_trips": (
        ["/".join("a" for _ in range(40)) + "/f"], None, (),
        {"max_depth": 16}, ("ResourceBudgetExceeded", "deeper")),
    "entry_flood_trips_in_batches": (
        [f"f{i}" for i in range(200)], None, (), {"max_files": 100},
        ("ResourceBudgetExceeded", "entry count")),
    "oversize_member_trips": (
        ["big.bin"], {"big.bin": 100}, (), {"max_file_bytes": 10},
        ("ResourceBudgetExceeded", "per-file")),
    "system_dirs_skipped": (
        ["proc/1/status", "sys/x", "dev/null", "etc/os-release",
         "srv/proc/x"], None, (), {}, ["etc/os-release", "srv/proc/x"]),
    "link_escapes_noted_guarded": (
        ["etc/passwd"], None,
        (("srv/app/passwd", "/etc/passwd", tarfile.LNKTYPE),
         ("srv/up", "../../../x", tarfile.SYMTYPE),
         ("usr/bin/sh", "/bin/busybox", tarfile.SYMTYPE)), {},
        ["etc/passwd"]),
    "entries_charged_under_a_batch": (
        [f"d/f{i}" for i in range(70)], {"d/f3": 5}, (), {},
        [f"d/f{i}" for i in range(70)]),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_layer_walk_equals_reference(case):
    names, sizes, links, limits, expected = WALK_CASES[case]
    kind, value = _both(_walk(_tar(names, sizes, links), limits))
    if isinstance(expected, tuple):
        assert kind == expected[0] and expected[1] in value
        return
    assert kind == "ok"
    (files, opq, wh), budget = value
    assert [p for p, _, _ in files] == expected
    if case == "whiteout_traversal_skipped_unguarded":
        assert (opq, wh) == (["dir"], ["app/x"])
    if case == "link_escapes_noted_guarded":
        # the hardlink out of the root and the relative symlink escape
        # are noted; an absolute symlink is normal in an image
        assert [k for k, _ in budget[1]] == ["malformed-archive"] * 2
    if case == "entries_charged_under_a_batch":
        assert budget[0] == 70 and files[3][1:] == (5, b"xxxxx")


def test_traversal_counted_in_both_packages():
    names = ["../../etc/passwd", "a/../../b", "ok.txt"]
    before = {k: m[0].GUARD_METRICS.snapshot()["traversal_rejected"]
              for k, m in PKGS.items()}
    _both(_walk(_tar(names)))
    for k, m in PKGS.items():
        assert m[0].GUARD_METRICS.snapshot()["traversal_rejected"] \
            == before[k] + 2


# --- the budget and safe-tar primitives (TestBudgetPrimitives) ----------

def _ratio_tripwire(guard, budget, safetar, walker):
    lim = guard.ResourceLimits(max_decompressed_bytes=1 << 30,
                               max_compression_ratio=100.0,
                               ratio_min_bytes=1 << 16)
    b = guard.ResourceBudget(lim)
    try:
        guard.decompress_bounded(gzip.compress(b"\0" * (8 << 20),
                                               mtime=0), b)
    finally:
        assert b.decompressed < (8 << 20)      # never materialized


def _absolute_cap(guard, budget, safetar, walker):
    lim = guard.ResourceLimits(max_decompressed_bytes=1000,
                               max_compression_ratio=1e9)
    guard.open_layer_bytes(b"A" * 2000, guard.ResourceBudget(lim))


def _truncated_gzip(guard, budget, safetar, walker):
    whole = gzip.compress(b"payload" * 1000, mtime=0)
    guard.decompress_bounded(whole[:len(whole) // 2],
                             guard.ResourceBudget())


def _truncated_gzip_unguarded(guard, budget, safetar, walker):
    whole = gzip.compress(b"payload" * 1000, mtime=0)
    guard.decompress_bounded(whole[:len(whole) // 2], None)


def _garbage_layer(guard, budget, safetar, walker):
    guard.open_layer_bytes(b"not a tar at all" * 100,
                           guard.ResourceBudget())


def _gzip_layer_bounded(guard, budget, safetar, walker):
    layer = _tar(["a/b.txt", "c"], {"a/b.txt": 3000})
    b = guard.ResourceBudget()
    with guard.open_layer_bytes(gzip.compress(layer, mtime=0), b) as tf:
        names = tf.getnames()
    return names, b.decompressed == len(layer)


def _deadline(guard, budget, safetar, walker):
    b = guard.ResourceBudget(guard.ResourceLimits(ingest_deadline_s=0.001))
    time.sleep(0.01)
    b.check_deadline()


def _make_budget(guard, budget, safetar, walker):
    return (guard.make_budget(None, enabled=False),
            type(guard.make_budget(None, enabled=True)).__name__,
            guard.make_budget(None, name="img").limits
            == guard.DEFAULT_LIMITS)


def _trips_are_value_errors(guard, budget, safetar, walker):
    return [issubclass(c, ValueError) for c in (
        guard.GuardError, guard.MalformedArchiveError,
        guard.ResourceBudgetExceeded, guard.IngestDeadlineExceeded)] + [
        issubclass(guard.IngestDeadlineExceeded,
                   guard.ResourceBudgetExceeded),
        guard.MalformedArchiveError.kind,
        guard.ResourceBudgetExceeded.stage]


def _metric_counters(guard, budget, safetar, walker):
    snap = guard.GUARD_METRICS.snapshot()
    return sorted(snap), all(isinstance(v, int) for v in snap.values())


def _guard_metrics_in_scheduler_stats(guard, budget, safetar, walker):
    import importlib
    sched = importlib.import_module(
        guard.__name__.split(".")[0] + ".sched")
    s = sched.ScanScheduler(backend="cpu")
    try:
        snap = s.stats()
    finally:
        s.close()
    return ("budget_trips" in snap["guard"],
            sorted(snap["guard"]) == sorted(guard.GUARD_METRICS.snapshot()))


def _named_trip(guard, budget, safetar, walker):
    budget.ResourceBudget(name="img.tar").exceeded("too big")


def _scaled_limits(guard, budget, safetar, walker):
    return dataclasses.asdict(guard.DEFAULT_LIMITS.scaled(0.05))


def _layer_budget_rolls_up(guard, budget, safetar, walker):
    parent = guard.ResourceBudget(guard.ResourceLimits(max_files=100))
    child = budget.LayerBudget(parent)
    child.charge_decompressed(1000)
    child.charge_entries(60)
    child.note("malformed-archive", "x")
    try:
        budget.LayerBudget(parent).charge_entries(60)
    finally:
        assert (parent.decompressed, parent.entries,
                parent.soft_faults) == (1000, 120,
                                        [("malformed-archive", "x")])


def _soft_fault_on_the_active_budget(guard, budget, safetar, walker):
    b = guard.ResourceBudget()
    assert guard.current_budget.get() is None
    with b.activate():
        guard.current_budget.get().note("malformed-archive", "corrupt")
    return guard.current_budget.get(), b.soft_faults, b.stats()


def _digests(guard, budget, safetar, walker):
    out = []
    for d in ("sha256:" + "ab" * 32, "sha512:" + "0F" * 64, "",
              "sha256:../../../etc/secret", "sha256:" + "ab" * 8,
              "SHA256:" + "ab" * 32):
        try:
            out.append(guard.validate_digest(d))
        except guard.MalformedArchiveError as e:
            out.append(str(e))
    return out


def _paths(guard, budget, safetar, walker):
    out = [safetar.has_traversal(p) for p in
           ("..", "../a", "a/../..", "a/..", "a/b", "a..b", "/..x")]
    for name, target, kind in (
            ("a/b", "../../c", tarfile.SYMTYPE),
            ("a/b", "../c", tarfile.SYMTYPE),
            ("a/b", "/etc/x", tarfile.SYMTYPE),
            ("a/b", "/etc/x", tarfile.LNKTYPE),
            ("a/b", "c", tarfile.LNKTYPE),
            ("a/b", "", tarfile.REGTYPE)):
        ti = tarfile.TarInfo(name)
        ti.type = kind
        ti.linkname = target
        out.append(safetar.link_escapes(ti))
    return out


def _read_member(guard, budget, safetar, walker):
    data = _tar(["f"], {"f": 50})
    tf = tarfile.open(fileobj=io.BytesIO(data[:512 + 20]))
    member = tf.next()
    return safetar.read_member(tf, member)


def _read_member_unchecked(guard, budget, safetar, walker):
    tf = tarfile.open(fileobj=io.BytesIO(_tar(["f"], {"f": 50})))
    member = tf.next()
    safetar.read_member(tf, member,
                        guard.ResourceBudget(guard.ResourceLimits(
                            max_file_bytes=10)), checked=False)


PRIMITIVE_CASES = {
    "ratio_tripwire_before_absolute_cap": (
        _ratio_tripwire, ("ResourceBudgetExceeded", "ratio")),
    "absolute_byte_cap": (_absolute_cap, ("ResourceBudgetExceeded",
                                          "budget")),
    "truncated_gzip_is_malformed": (_truncated_gzip,
                                    ("MalformedArchiveError", "")),
    "truncated_gzip_unguarded_is_malformed": (
        _truncated_gzip_unguarded, ("MalformedArchiveError", "corrupt")),
    "garbage_layer_is_malformed": (_garbage_layer,
                                   ("MalformedArchiveError", "")),
    "gzip_layer_charged_decompressed": (_gzip_layer_bounded,
                                        (["a/b.txt", "c"], True)),
    "deadline_trips": (_deadline, ("IngestDeadlineExceeded", "deadline")),
    "make_budget_disabled": (_make_budget,
                             (None, "ResourceBudget", True)),
    "trips_are_value_errors": (
        _trips_are_value_errors,
        [True] * 5 + ["malformed-archive", "ingest"]),
    "guard_metric_counters": (_metric_counters, None),
    "guard_metrics_in_scheduler_stats": (
        _guard_metrics_in_scheduler_stats, (True, True)),
    "named_trip_prefix": (_named_trip, ("ResourceBudgetExceeded",
                                        "img.tar: too big")),
    "scaled_limits": (_scaled_limits, None),
    "layer_budget_rolls_up": (_layer_budget_rolls_up,
                              ("ResourceBudgetExceeded", "entry count")),
    "soft_fault_on_the_active_budget": (
        _soft_fault_on_the_active_budget,
        (None, [("malformed-archive", "corrupt")],
         {"decompressed": 0, "entries": 0, "soft_faults": 1})),
    "validate_digest": (_digests, None),
    "traversal_and_link_escapes": (
        _paths, [True, True, True, True, False, False, False,
                 True, False, False, True, False, False]),
    "truncated_member_is_malformed": (
        _read_member, ("MalformedArchiveError", "truncated")),
    "unchecked_member_size_trips": (
        _read_member_unchecked, ("ResourceBudgetExceeded", "per-file")),
}


@pytest.mark.parametrize("case", sorted(PRIMITIVE_CASES))
def test_budget_primitive_equals_reference(case):
    fn, expected = PRIMITIVE_CASES[case]
    kind, value = _both(fn)
    if expected is None:
        assert kind == "ok"
    elif isinstance(expected, tuple) and isinstance(expected[0], str) \
            and expected[0].endswith(("Error", "Exceeded")):
        assert kind == expected[0] and expected[1] in value
    else:
        assert (kind, value) == ("ok", expected)


def test_scaled_limits_value():
    lim = tguard.DEFAULT_LIMITS.scaled(0.05)
    assert dataclasses.asdict(lim) == \
        dataclasses.asdict(rguard.DEFAULT_LIMITS.scaled(0.05))
    assert lim.max_files == 5000 and \
        lim.ingest_deadline_s == tguard.DEFAULT_LIMITS.ingest_deadline_s


def test_ratio_tripwire_counts_each_stream_alone():
    """Two gzip streams charged to one budget, the first incompressible
    and past ``ratio_min_bytes``, the second small and plain text: the
    JAX package holds the running total against the second stream's
    compressed size and trips; the port holds each stream's own bytes
    against its own size, and a bomb still trips it."""
    import random
    first = gzip.compress(random.Random(1).randbytes(200_000), mtime=0)
    second = gzip.compress(b"key = value\n" * 200, mtime=0)
    bomb = gzip.compress(b"\0" * (1 << 20), mtime=0)

    def run(guard, budget, safetar, walker):
        b = guard.ResourceBudget(guard.ResourceLimits(
            max_compression_ratio=100.0, ratio_min_bytes=1 << 16))
        return [len(guard.decompress_bounded(x, b))
                for x in (first, second, bomb)]

    outcome = {k: _outcome(lambda m=m: run(*m)) for k, m in PKGS.items()}
    assert outcome["ref"][0] == "ResourceBudgetExceeded"
    assert f"{200_000 + 2400} bytes from {len(second)} compressed" in \
        outcome["ref"][1]
    assert outcome["port"][0] == "ResourceBudgetExceeded"
    assert outcome["port"][1].startswith(
        f"compression ratio tripwire: {1 << 17} bytes from {len(bomb)} ")
