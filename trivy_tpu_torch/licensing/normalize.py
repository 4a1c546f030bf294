"""License name normalization (reference: pkg/licensing/normalize.go
— factual mapping constants)."""

from __future__ import annotations

_MAPPING = {
    # GPL
    "GPL-1": "GPL-1.0", "GPL-1+": "GPL-1.0", "GPL 1.0": "GPL-1.0",
    "GPL 1": "GPL-1.0",
    "GPL2": "GPL-2.0", "GPL 2.0": "GPL-2.0", "GPL 2": "GPL-2.0",
    "GPL-2": "GPL-2.0", "GPL-2.0-ONLY": "GPL-2.0", "GPL2+": "GPL-2.0",
    "GPLV2+": "GPL-2.0", "GPL-2+": "GPL-2.0", "GPL-2.0+": "GPL-2.0",
    "GPL-2.0-OR-LATER": "GPL-2.0",
    "GPL-2+ WITH AUTOCONF EXCEPTION":
        "GPL-2.0-with-autoconf-exception",
    "GPL3": "GPL-3.0", "GPL 3.0": "GPL-3.0", "GPL 3": "GPL-3.0",
    "GPLV3+": "GPL-3.0", "GPL-3": "GPL-3.0",
    "GPL-3.0-ONLY": "GPL-3.0", "GPL3+": "GPL-3.0",
    "GPL-3+": "GPL-3.0", "GPL-3.0-OR-LATER": "GPL-3.0",
    # the reference maps the GPL-3 bison variant onto the GPL-2.0
    # exception id (normalize.go:31) — kept verbatim for parity; both
    # land in the restricted category either way. The spaced forms
    # are what dpkg copyright files actually contain.
    "GPL-3+-WITH-BISON-EXCEPTION": "GPL-2.0-with-bison-exception",
    "GPL-3+ WITH BISON EXCEPTION": "GPL-2.0-with-bison-exception",
    "GPL": "GPL-3.0",
    # LGPL
    "LGPL2": "LGPL-2.0", "LGPL 2": "LGPL-2.0",
    "LGPL 2.0": "LGPL-2.0", "LGPL-2": "LGPL-2.0",
    "LGPL2+": "LGPL-2.0", "LGPL-2+": "LGPL-2.0",
    "LGPL-2.0+": "LGPL-2.0",
    "LGPL-2.1": "LGPL-2.1", "LGPL 2.1": "LGPL-2.1",
    "LGPL-2.1+": "LGPL-2.1", "LGPLV2.1+": "LGPL-2.1",
    "LGPL-3": "LGPL-3.0", "LGPL 3": "LGPL-3.0",
    "LGPL-3+": "LGPL-3.0", "LGPL": "LGPL-3.0",
    # MPL
    "MPL1.0": "MPL-1.0", "MPL1": "MPL-1.0", "MPL 1.0": "MPL-1.0",
    "MPL 1": "MPL-1.0",
    "MPL2.0": "MPL-2.0", "MPL 2.0": "MPL-2.0", "MPL2": "MPL-2.0",
    "MPL 2": "MPL-2.0",
    # BSD
    "BSD": "BSD-3-Clause", "BSD-2-CLAUSE": "BSD-2-Clause",
    "BSD-3-CLAUSE": "BSD-3-Clause", "BSD-4-CLAUSE": "BSD-4-Clause",
    "APACHE": "Apache-2.0", "APACHE 2.0": "Apache-2.0",
    "RUBY": "Ruby", "ZLIB": "Zlib",
}


def normalize(name: str) -> str:
    upper = name.upper()
    if upper in _MAPPING:
        return _MAPPING[upper]
    # SPDX modifier suffixes reduce to the base id
    for suffix in ("-ONLY", "-OR-LATER"):
        if upper.endswith(suffix):
            return normalize(name[: -len(suffix)])
    return name
