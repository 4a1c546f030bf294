"""License scanning (reference: pkg/licensing).

Category lists, name normalization, the category→severity scanner
(scanner.go:23-44), and a phrase-based classifier replacing the
reference's google/licenseclassifier dependency (classifier.go:42).
Host-side feature: classification is irregular text matching.
"""

from __future__ import annotations

from .classifier import classify, classify_findings
from .normalize import normalize

# Category names (ref pkg/fanal/types LicenseCategory)
FORBIDDEN = "forbidden"
RESTRICTED = "restricted"
RECIPROCAL = "reciprocal"
NOTICE = "notice"
PERMISSIVE = "permissive"
UNENCUMBERED = "unencumbered"
UNKNOWN = "unknown"

# License name lists per category — factual constants ported from the
# reference's category.go (itself ported from google/licenseclassifier
# license_type.go); the compat contract for category mapping.
FORBIDDEN_LICENSES = [
    "AGPL-1.0", "AGPL-3.0",
    "CC-BY-NC-1.0", "CC-BY-NC-2.0", "CC-BY-NC-2.5", "CC-BY-NC-3.0",
    "CC-BY-NC-4.0",
    "CC-BY-NC-ND-1.0", "CC-BY-NC-ND-2.0", "CC-BY-NC-ND-2.5",
    "CC-BY-NC-ND-3.0", "CC-BY-NC-ND-4.0",
    "CC-BY-NC-SA-1.0", "CC-BY-NC-SA-2.0", "CC-BY-NC-SA-2.5",
    "CC-BY-NC-SA-3.0", "CC-BY-NC-SA-4.0",
    "Commons-Clause", "Facebook-2-Clause", "Facebook-3-Clause",
    "Facebook-Examples", "WTFPL",
]

RESTRICTED_LICENSES = [
    "BCL", "CC-BY-ND-1.0", "CC-BY-ND-2.0", "CC-BY-ND-2.5",
    "CC-BY-ND-3.0", "CC-BY-ND-4.0", "CC-BY-SA-1.0", "CC-BY-SA-2.0",
    "CC-BY-SA-2.5", "CC-BY-SA-3.0", "CC-BY-SA-4.0",
    "GPL-1.0", "GPL-2.0", "GPL-2.0-with-autoconf-exception",
    "GPL-2.0-with-bison-exception",
    "GPL-2.0-with-classpath-exception",
    "GPL-2.0-with-font-exception", "GPL-2.0-with-GCC-exception",
    "GPL-3.0", "GPL-3.0-with-autoconf-exception",
    "GPL-3.0-with-GCC-exception",
    "LGPL-2.0", "LGPL-2.1", "LGPL-3.0",
    "NPL-1.0", "NPL-1.1", "OSL-1.0", "OSL-1.1", "OSL-2.0",
    "OSL-2.1", "OSL-3.0", "QPL-1.0", "Sleepycat",
]

RECIPROCAL_LICENSES = [
    "APSL-1.0", "APSL-1.1", "APSL-1.2", "APSL-2.0",
    "CDDL-1.0", "CDDL-1.1", "CPL-1.0", "EPL-1.0", "EPL-2.0",
    "FreeImage", "IPL-1.0", "MPL-1.0", "MPL-1.1", "MPL-2.0", "Ruby",
]

NOTICE_LICENSES = [
    "AFL-1.1", "AFL-1.2", "AFL-2.0", "AFL-2.1", "AFL-3.0",
    "Apache-1.0", "Apache-1.1", "Apache-2.0",
    "Artistic-1.0-cl8", "Artistic-1.0-Perl", "Artistic-1.0",
    "Artistic-2.0", "BSL-1.0",
    "BSD-2-Clause-FreeBSD", "BSD-2-Clause-NetBSD", "BSD-2-Clause",
    "BSD-3-Clause-Attribution", "BSD-3-Clause-Clear",
    "BSD-3-Clause-LBNL", "BSD-3-Clause", "BSD-4-Clause",
    "BSD-4-Clause-UC", "BSD-Protection",
    "CC-BY-1.0", "CC-BY-2.0", "CC-BY-2.5", "CC-BY-3.0", "CC-BY-4.0",
    "FTL", "ISC", "ImageMagick", "Libpng", "Lil-1.0",
    "Linux-OpenIB", "LPL-1.02", "LPL-1.0", "MS-PL", "MIT", "NCSA",
    "OpenSSL", "PHP-3.01", "PHP-3.0", "PIL", "Python-2.0",
    "Python-2.0-complete", "PostgreSQL",
    "SGI-B-1.0", "SGI-B-1.1", "SGI-B-2.0",
    "Unicode-DFS-2015", "Unicode-DFS-2016", "Unicode-TOU",
    "UPL-1.0", "W3C-19980720", "W3C-20150513", "W3C", "X11", "Xnet",
    "Zend-2.0", "zlib-acknowledgement", "Zlib",
    "ZPL-1.1", "ZPL-2.0", "ZPL-2.1",
]

UNENCUMBERED_LICENSES = ["CC0-1.0", "Unlicense", "0BSD"]

DEFAULT_CATEGORIES = {
    FORBIDDEN: FORBIDDEN_LICENSES,
    RESTRICTED: RESTRICTED_LICENSES,
    RECIPROCAL: RECIPROCAL_LICENSES,
    NOTICE: NOTICE_LICENSES,
    PERMISSIVE: [],
    UNENCUMBERED: UNENCUMBERED_LICENSES,
}

_CATEGORY_SEVERITY = {
    FORBIDDEN: "CRITICAL",
    RESTRICTED: "HIGH",
    RECIPROCAL: "MEDIUM",
    NOTICE: "LOW",
    PERMISSIVE: "LOW",
    UNENCUMBERED: "LOW",
}


class LicenseScanner:
    """license name → (category, severity) (ref scanner.go:23-44);
    a custom category map overrides the defaults."""

    def __init__(self, categories=None):
        self.categories = categories or DEFAULT_CATEGORIES

    def scan(self, license_name: str) -> tuple:
        # normalize vendor/SPDX variants (GPL-3.0-only, GPLv2+) so
        # they hit the canonical category lists
        name = normalize(license_name)
        for category, names in self.categories.items():
            if name in names:
                return category, _CATEGORY_SEVERITY.get(
                    category, "UNKNOWN")
        return UNKNOWN, "UNKNOWN"


__all__ = ["LicenseScanner", "DEFAULT_CATEGORIES", "normalize",
           "classify", "classify_findings",
           "FORBIDDEN", "RESTRICTED", "RECIPROCAL", "NOTICE",
           "PERMISSIVE", "UNENCUMBERED", "UNKNOWN"]
