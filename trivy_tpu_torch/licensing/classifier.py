"""Phrase-based license classifier.

The reference wraps google/licenseclassifier v2 (classifier.go:42),
which ships a corpus of full license texts. This re-design detects
licenses from three signals, strongest first:

1. an explicit ``SPDX-License-Identifier:`` tag (confidence 1.0),
2. n-gram containment against the embedded corpus of license
   cores (corpus.py) — catches reflowed/re-indented bodies,
3. a distinctive full-text phrase unique to one license,
4. the license's canonical title line.

That covers the common case — LICENSE/COPYING files and source
headers for the licenses that dominate real software — without the
megabyte corpus. Confidence reflects the signal: 1.0 for SPDX tags,
the containment fraction (>= 0.9) for corpus matches, 0.9 for
distinctive phrases, 0.8 for title matches.
"""

from __future__ import annotations

import re

from ..types import LicenseFile, LicenseFinding
from .normalize import normalize

# max bytes inspected for header classification (code files)
HEAD_SIZE = 4096

_SPDX_RE = re.compile(
    r"SPDX-License-Identifier:\s*\(?([A-Za-z0-9.+-]+"
    r"(?:\s+(?:OR|AND|WITH)\s+[A-Za-z0-9.+-]+)*)\)?",
    re.IGNORECASE)

# (license, distinctive phrase) — lowercase substring unique enough to
# identify the license body
_PHRASES = [
    ("MIT", "permission is hereby granted, free of charge, to any "
     "person obtaining a copy"),
    ("Apache-2.0", "licensed under the apache license, version 2.0"),
    ("Apache-2.0", "apache license\n"
     "                           version 2.0, january 2004"),
    ("GPL-3.0", "gnu general public license\n"
     "                       version 3, 29 june 2007"),
    ("GPL-3.0", "under the terms of the gnu general public license "
     "as published by\nthe free software foundation, either "
     "version 3"),
    ("GPL-2.0", "gnu general public license, version 2"),
    ("GPL-2.0", "gnu general public license\n"
     "                       version 2, june 1991"),
    ("GPL-2.0", "under the terms of the gnu general public license "
     "as published by\nthe free software foundation; either "
     "version 2"),
    ("LGPL-3.0", "gnu lesser general public license\n"
     "                       version 3, 29 june 2007"),
    ("LGPL-2.1", "gnu lesser general public license\n"
     "                       version 2.1, february 1999"),
    ("AGPL-3.0", "gnu affero general public license\n"
     "                       version 3, 19 november 2007"),
    ("AGPL-3.0", "gnu affero general public license as published"),
    ("BSD-3-Clause", "neither the name of"),
    ("BSD-2-Clause", "redistributions in binary form must reproduce "
     "the above copyright"),
    ("MPL-2.0", "this source code form is subject to the terms of "
     "the mozilla public\nlicense, v. 2.0"),
    ("MPL-2.0", "mozilla public license version 2.0"),
    ("ISC", "permission to use, copy, modify, and/or distribute "
     "this software for any\npurpose with or without fee"),
    ("Unlicense", "this is free and unencumbered software released "
     "into the public domain"),
    ("WTFPL", "do what the fuck you want to public license"),
    ("CC0-1.0", "creative commons legal code\n\ncc0 1.0 universal"),
    ("CC0-1.0", "cc0 1.0 universal"),
    ("EPL-2.0", "eclipse public license - v 2.0"),
    ("EPL-1.0", "eclipse public license - v 1.0"),
    ("Zlib", "this software is provided 'as-is', without any "
     "express or implied\nwarranty"),
    ("OpenSSL", "openssl license"),
    ("Artistic-2.0", "the artistic license 2.0"),
    ("0BSD", "zero-clause bsd"),
]

# BSD-2 phrase is a subset of BSD-3 text; check specificity order and
# keep the first (most specific) hit per license family
_FAMILY = {
    "BSD-2-Clause": "bsd", "BSD-3-Clause": "bsd",
    "GPL-2.0": "gpl", "GPL-3.0": "gpl",
    "LGPL-2.1": "lgpl", "LGPL-3.0": "lgpl",
    "EPL-1.0": "epl", "EPL-2.0": "epl",
    "AGPL-3.0": "agpl",
}

_AVD_LINK = "https://spdx.org/licenses/{}.html"


def classify_findings(content: bytes) -> list:
    """→ [LicenseFinding], best signal per license family."""
    text = content.decode("utf-8", "replace")
    findings = []
    seen = set()
    families = set()

    for m in _SPDX_RE.finditer(text):
        for name in re.split(r"\s+(?:OR|AND)\s+", m.group(1),
                             flags=re.IGNORECASE):
            # "X WITH exception" qualifies X; the exception is not a
            # license of its own
            name = re.split(r"\s+WITH\s+", name,
                            flags=re.IGNORECASE)[0].strip("()")
            if name and name not in seen:
                seen.add(name)
                canonical = normalize(name)
                families.add(_FAMILY.get(canonical, canonical))
                findings.append(LicenseFinding(
                    name=name, confidence=1.0,
                    link=_AVD_LINK.format(name)))

    from .corpus import corpus_matches
    for name, confidence in corpus_matches(text):
        family = _FAMILY.get(name, name)
        if name in seen or family in families:
            continue
        seen.add(name)
        families.add(family)
        findings.append(LicenseFinding(
            name=name, confidence=confidence,
            link=_AVD_LINK.format(name)))

    lowered = text.lower()
    for name, phrase in _PHRASES:
        if name in seen:
            continue
        family = _FAMILY.get(name, name)
        if family in families:
            continue
        if phrase in lowered:
            seen.add(name)
            families.add(family)
            findings.append(LicenseFinding(
                name=name, confidence=0.9,
                link=_AVD_LINK.format(name)))
    return findings


def is_human_readable(content: bytes) -> bool:
    """Binary sniff (ref license.go isHumanReadable — file(1)'s text
    heuristic)."""
    head = content[:300]
    for b in head:
        if b < 7 or b == 11 or 13 < b < 27 or 27 < b < 0x20 or \
                b == 0x7F:
            return False
    return True


def classify(file_path: str, content: bytes,
             full: bool = False) -> LicenseFile:
    """File → LicenseFile (ref classifier.go Classify/FullClassify):
    license-named files classify on the whole text, code files on the
    head only."""
    data = content if full else content[:HEAD_SIZE]
    return LicenseFile(
        type="license-file" if full else "header",
        file_path=file_path,
        findings=classify_findings(data),
    )
