"""Federated CVE impact queries (reference:
``trivy_tpu/impact/federate.py``; docs/serving.md "CVE impact queries
& push re-scans").

A federating front (the router's, ``router/front.py``, or any caller
with a replica list) answers ``GET /impact?cve=`` by fanning the query
out to every replica's local slice and unioning the answers —
Federator semantics throughout (obs/federate.py): bounded fan-in,
per-peer timeout, and a ``complete`` flag that goes False the moment
ANY peer is down or answered from a degraded index. A partial fleet
gives a partial answer, never an error: ring slices partition the
layer-digest space, so the union over the replicas that did answer
is exact for the slices they own.
"""

from __future__ import annotations

import json
import threading


def fetch_impact(url: str, cve: str, token: str = "",
                 token_header: str = "Trivy-Token",
                 timeout_s: float = 2.0) -> dict:
    """One replica's slice — raises on transport/decode failure (the
    caller's fan-out absorbs it into a down row)."""
    import urllib.parse
    import urllib.request
    req = urllib.request.Request(
        url.rstrip("/") + "/impact?cve="
        + urllib.parse.quote(cve, safe=""))
    if token:
        req.add_header(token_header, token)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        doc = json.loads(resp.read().decode("utf-8"))
    if not isinstance(doc, dict):
        raise ValueError("impact answer is not a JSON object")
    return doc


def federated_impact(replicas, cve: str, token: str = "",
                     token_header: str = "Trivy-Token",
                     timeout_s: float = 2.0, fan_in: int = 8,
                     fetch=None) -> dict:
    """Union of every replica's owned slice for one CVE.

    ``replicas`` is ``[(name, url), ...]`` (a router ring's handle
    list); ``fetch(url, cve) -> dict`` is injectable so unit tests
    exercise the merge without sockets. Never raises."""
    fetch = fetch or (lambda u, c: fetch_impact(
        u, c, token=token, token_header=token_header,
        timeout_s=timeout_s))
    replicas = list(replicas)
    rows: list = [None] * len(replicas)
    sem = threading.Semaphore(max(1, int(fan_in)))

    def work(i: int, name: str, url: str) -> None:
        with sem:
            try:
                doc = fetch(url, cve)
            except Exception as e:  # noqa: BLE001 — a down peer is
                # the condition federation exists to absorb: mark it,
                # answer partially
                rows[i] = {"replica": name, "up": False,
                           "complete": False, "error": repr(e)}
                return
            rows[i] = {"replica": name, "up": True,
                       "complete": bool(doc.get("complete", True)),
                       "error": "", "answer": doc}

    threads = [threading.Thread(target=work, args=(i, n, u),
                                daemon=True)
               for i, (n, u) in enumerate(replicas)]
    for t in threads:
        t.start()
    for t in threads:
        # second-layer backstop over the per-fetch timeout, so a
        # wedged socket cannot wedge the query
        t.join(timeout_s * 2 + 1.0)
    for i, (name, _url) in enumerate(replicas):
        if rows[i] is None:
            rows[i] = {"replica": name, "up": False,
                       "complete": False, "error": "query timeout"}

    packages: set = set()
    layers: set = set()
    images: dict = {}
    for row in rows:
        answer = row.get("answer")
        if not answer:
            continue
        packages.update(a for a in answer.get("packages", ())
                        if isinstance(a, str))
        layers.update(a for a in answer.get("layers", ())
                      if isinstance(a, str))
        for pair in answer.get("images", ()):
            if isinstance(pair, (list, tuple)) and len(pair) == 2:
                images[str(pair[0])] = str(pair[1])
    complete = all(r["up"] and r["complete"] for r in rows) \
        if rows else True
    return {
        "cve": cve,
        "packages": sorted(packages),
        "layers": sorted(layers),
        "images": sorted([i, t] for i, t in images.items()),
        "complete": complete,
        "replicas": [{k: r[k] for k in
                      ("replica", "up", "complete", "error")}
                     for r in rows],
    }
