"""YAML bucket fixture loader — the dbtest pattern.

Reference: pkg/dbtest/db.go loads YAML fixtures (bucket → package →
CVE → advisory, integration/testdata/fixtures/db/*.yaml) into a temp
BoltDB via bolt-fixtures. Here they load straight into AdvisoryStore;
the fixture FORMAT is kept identical so the reference's fixture files
remain usable."""

from __future__ import annotations

import re as _re

from .store import AdvisoryStore

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


def load_fixtures(paths: list, store: AdvisoryStore = None)\
        -> AdvisoryStore:
    if yaml is None:  # pragma: no cover
        raise RuntimeError("PyYAML required for fixture loading")
    if store is None:
        store = AdvisoryStore()
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        try:
            docs = yaml.safe_load(text) or []
        except yaml.YAMLError:
            # the reference's own fixtures carry go-yaml-tolerated
            # quirks (trailing comma after a quoted list item);
            # strip them and retry
            cleaned = _re.sub(r'^(\s*- ".*"),\s*$', r"\1", text,
                              flags=_re.MULTILINE)
            docs = yaml.safe_load(cleaned) or []
        for top in docs:
            _load_bucket(store, top)
    return store


def _load_bucket(store: AdvisoryStore, top: dict) -> None:
    bucket = top.get("bucket", "")
    pairs = top.get("pairs") or []
    if bucket == "vulnerability":
        for p in pairs:
            store.put_vulnerability(p["key"], p.get("value") or {})
        return
    if bucket == "data-source":
        for p in pairs:
            store.put_data_source(p["key"], p.get("value") or {})
        return
    for p in pairs:
        if "bucket" in p:        # nested: package bucket
            pkg = p["bucket"]
            for kv in p.get("pairs") or []:
                store.put_advisory(bucket, pkg, kv["key"],
                                   kv.get("value") or {})
        else:                    # flat key under source bucket
            store.put_advisory(bucket, p["key"], "", p.get("value")
                               or {})
