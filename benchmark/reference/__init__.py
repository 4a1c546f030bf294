"""The plain reference: what each scan should find, worked out again from
the generated inputs alone (the advisory rows before any compile, the
files of each image, the packages written into each BOM) with frozen
copies of the version grammars and the built-in secret rules.

It imports nothing of the program. ``expected_image`` and
``expected_bom`` give, per target, the sets the comparison
(``benchmark/compare.py``) holds the program's report against.
"""

from __future__ import annotations

import json
import tarfile

from .secrets import scan_file
from .vulns import expected


def image_layers(path: str) -> list:
    """[(DiffID-less layer name, [(rel_path, bytes)])] of a ``docker
    save`` tarball, bottom first, as its manifest lists them."""
    with tarfile.open(path) as tf:
        manifest = json.load(tf.extractfile("manifest.json"))[0]
        out = []
        for name in manifest["Layers"]:
            inner = tarfile.open(fileobj=tf.extractfile(name))
            files = [(m.name, inner.extractfile(m).read())
                     for m in inner.getmembers() if m.isfile()]
            out.append((name, files))
    return out


def expected_image(entry: dict, shape: dict, plans: list,
                   base_layers: int, rules=None) -> dict:
    """{"packages", "vulns", "secrets"} of one pool tag: its packages
    and findings from the generator's truth, and the secrets of every
    file of the layers above its base (``base_layers``), each with the
    DiffID of its layer."""
    truth = entry["truth"]
    pkgs, found = expected(plans, shape, truth, truth.get("src", {}))
    secrets = set()
    for li, (_, files) in enumerate(image_layers(entry["path"])):
        if li < base_layers:
            continue
        diff_id = entry["diff_ids"][li]
        for path, content in files:
            secrets |= {f + (diff_id,)
                        for f in scan_file(path, content, rules)}
    return {"packages": pkgs, "vulns": found, "secrets": secrets}


def expected_bom(entry: dict, shape: dict, plans: list) -> dict:
    """{"vulns"} of one pool BOM, from the generator's truth."""
    _, found = expected(plans, shape, entry["truth"], {},
                        lockfiles=False)
    return {"vulns": found}
