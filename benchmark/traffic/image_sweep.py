"""A registry sweep: a pool of ``docker save`` tags, all submitted ahead.

The pool is drawn from the seed as the workload's ``images`` say: per
kind of image, ``tags`` tags that share one base (the kind's OS root,
with a secret that the base's history keeps from being reported) and
one layer holding a shared secret, each with lockfiles of its own and
one part of the kind's corpus, a part per group of ``group`` tags
(``chip_smoke.py``'s ``fleet_targets``). Every seed has the same
kinds, counts and sizes; the seed draws the versions and the corpus,
and the order of each kind's tags, which are spread evenly over the
pass (``mix.spread``). The pool is written once per seed into the
cache and reused by later runs of that seed.

Tags go through ``BatchScanRunner.submit_path`` on a runner with an
empty blob cache and memo, ``in_flight`` of them submitted ahead at
any time: the next is submitted as a report is written (the command's
JSON). Set-up starts the pass and waits until ``ramp`` reports were
written: the kernels are loaded and the pipeline is full when the
window opens. When the window's time is up nothing more is submitted,
every tag already submitted is waited for, and the clock is read after
that wait: every report written since the window opened counts, over
all of that time. A pass that ends inside the window is followed by
one on a new runner with an empty cache and memo; the database and the
kernels stay loaded.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from ..reference import expected_image
from .corpus import SECRETS, make_corpus
from .mix import spread
from .trees import tree_files, write_docker_save

KIND_KEY = "kind"
HISTORY = (
    ("/bin/sh -c #(nop) ADD file:3b16ab4a8e1ec1fa in / ", False),
    ('/bin/sh -c #(nop)  CMD ["bash"]', True),
    ("COPY srv/shared /srv/shared # buildkit", False),
    ("COPY srv/app /srv/app # buildkit", False),
    ("COPY corpus / # buildkit", False),
    ('CMD ["/srv/app/run"]', True),
)
BASE_LAYERS = 1            # layers before the history's first CMD
BASE_SECRET = ("opt/base/release.env", SECRETS[1][0])
SHARED_SECRET = ("srv/shared/deploy.env", SECRETS[0][0])
MANIFEST = "pool.json"


def _rng(seed: int, *keys: int):
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *keys])


def build(params: dict, n_pkgs: dict, seed: int, pool_dir: str) -> dict:
    """Write the pool of ``seed`` under ``pool_dir`` (unless a complete
    one is there) and return its manifest: {"tags": [{"path", "kind",
    "index", "repo_tag", "diff_ids", "truth"}] in submission order}."""
    path = os.path.join(pool_dir, MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    shutil.rmtree(pool_dir, ignore_errors=True)
    os.makedirs(pool_dir)
    tags = []
    for k, kind in enumerate(params["images"]):
        tree, group = kind["tree"], kind["group"]
        n_groups = -(-kind["tags"] // group)
        n_files = kind["corpus_files"]
        corpus, _ = make_corpus(n_groups * n_files,
                                [int(seed) & (2 ** 64 - 1), k, 0])
        os_files, _, base_truth = tree_files(tree, n_pkgs, _rng(seed, k, 1))
        base = os_files + [BASE_SECRET]
        for t in range(kind["tags"]):
            _, lockfiles, truth = tree_files(tree, n_pkgs,
                                             _rng(seed, k, 2, t + 1))
            g = t // group
            part = corpus[g * n_files:(g + 1) * n_files]
            name = f"{tree['family']}-{t}"
            repo_tag = f"registry.example/sweep/{tree['family']}:{name}"
            tar = os.path.join(pool_dir, f"{name}.tar")
            diff_ids = write_docker_save(
                tar, [base, [SHARED_SECRET], lockfiles, part], HISTORY,
                repo_tag)
            tags.append({"path": tar, "kind": k, "index": t,
                         "repo_tag": repo_tag, "diff_ids": diff_ids,
                         "truth": {"os": base_truth["os"],
                                   "src": base_truth["src"],
                                   "apps": truth["apps"]}})
    manifest = {"tags": spread(tags, KIND_KEY, _rng(seed, 99))}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)
    return manifest


def expect(entry: dict, params: dict, plans: list) -> dict:
    """The reference's sets of one finished tag."""
    return expected_image(entry, params["images"][entry["kind"]]["tree"],
                          plans, BASE_LAYERS)


class Load:
    """The sweep over one pool. ``system``: the harness's view of the
    program (``make_runner(k)`` → (runner, options) on an empty blob
    cache and memo of pass ``k``; ``render(report)`` → text)."""

    def __init__(self, system, manifest: dict, params: dict):
        self.system = system
        self.tags = manifest["tags"]
        self.in_flight = params["in_flight"]
        self.ramp = params["ramp"]
        self.passes = 0
        self.runner = self.options = None
        self.next = 0                 # the pass's next tag to submit
        self.pending: dict = {}       # tag index → request
        self.sched: list = []         # (stats before, after) per runner
        self.before = None
        self.done: list = []          # (entry, text, monotonic time)
        self.failed: list = []        # (entry, error, monotonic time)

    def _submit(self) -> None:
        while len(self.pending) < self.in_flight and \
                self.next < len(self.tags):
            self.pending[self.next] = self.runner.submit_path(
                self.tags[self.next]["path"], self.options)
            self.next += 1

    def _start_pass(self) -> None:
        self.runner, self.options = self.system.make_runner(self.passes)
        self.passes += 1
        self.next = 0
        self._submit()

    def _end_pass(self) -> None:
        self.sched.append((self.before, self.runner.scheduler.stats()))
        self.before = None
        self.runner.close()
        self.runner = None

    def _poll(self, until: float, stop_after: int = 0) -> None:
        """Collect what completes until ``until`` (monotonic), or until
        ``stop_after`` more reports were written, keeping
        ``in_flight`` tags submitted and starting a new pass when one
        ends."""
        goal = len(self.done) + stop_after
        while time.monotonic() < until:
            if stop_after and len(self.done) >= goal:
                return
            if not self.pending:
                self._end_pass()
                self._start_pass()
            ready = [i for i, r in self.pending.items() if r.done]
            if not ready:
                time.sleep(0.005)
                continue
            for i in ready:
                self._collect(i, self.pending.pop(i))
            self._submit()

    def _collect(self, i: int, req) -> None:
        try:
            res = req.result()
        except Exception as e:   # noqa: BLE001 — a request that fails
            # is counted, not raised
            self.failed.append((self.tags[i], repr(e), time.monotonic()))
            return
        if res.error or res.status == "failed":
            self.failed.append((self.tags[i], res.error, time.monotonic()))
            return
        text = self.system.render(res.report)
        self.done.append((self.tags[i], text, time.monotonic()))

    def _drain(self, limit_s: float) -> None:
        """Collect every tag still pending, submitting nothing more; one
        with no answer ``limit_s`` after the close is counted failed."""
        deadline = time.monotonic() + limit_s
        while self.pending and time.monotonic() < deadline:
            ready = [i for i, r in self.pending.items() if r.done]
            if not ready:
                time.sleep(0.005)
                continue
            for i in ready:
                self._collect(i, self.pending.pop(i))
        for i in sorted(self.pending):
            self.failed.append((self.tags[i], f"no answer {limit_s:.0f} s "
                                f"after the close", time.monotonic()))
        self.pending.clear()

    def warm_up(self, limit_s: float = 600.0) -> None:
        """Start the first pass and wait for ``ramp`` reports."""
        self._start_pass()
        self._poll(time.monotonic() + limit_s, stop_after=self.ramp)
        if len(self.done) < self.ramp:
            raise RuntimeError(f"{len(self.done)} of {self.ramp} ramp "
                               f"scans in {limit_s:.0f} s; failed: "
                               f"{self.failed[:1]}")

    def run(self, seconds: float, drain_s: float = 120.0) -> dict:
        """Scan for ``seconds``, then wait for what was submitted;
        {"done": [(tag entry, report text, seconds into the window)],
        "failed": [(tag entry, error)], "passes", "window_s" (the open
        until the last wait ended), "in_window" (reports written before
        ``seconds``), "close_s", "sched": [(the scheduler's stats at the
        window's start or None, at its runner's close) per runner of
        the window]}."""
        self.sched = []
        self.before = self.runner.scheduler.stats()
        t0 = time.monotonic()
        n_done, n_failed = len(self.done), len(self.failed)
        self._poll(t0 + seconds)
        self._drain(drain_s)
        t_end = time.monotonic()
        self._end_pass()
        close_s = time.monotonic() - t_end
        done = self.done[n_done:]
        return {"done": [(e, text, at - t0) for e, text, at in done],
                "failed": [(e, err) for e, err, _ in self.failed[n_failed:]],
                "passes": self.passes, "window_s": t_end - t0,
                "in_window": sum(at <= t0 + seconds for _, _, at in done),
                "close_s": close_s, "sched": self.sched}
