"""License corpus similarity matching.

The reference wraps google/licenseclassifier v2
(pkg/licensing/classifier.go:42), which normalizes text and scores
q-gram overlap against a corpus of license texts, keeping matches
with confidence > 0.9 (classifier.go Classify). This module is the
same idea sized for an embedded corpus: each entry stores the
distinctive operative core of a license (not the megabyte full
text); a document matches when >= 90% of the entry's word 5-grams
appear in the document after normalization (lowercase, punctuation
folded, whitespace collapsed). That makes detection robust to
reflowed, re-indented, or re-wrapped license bodies that the
phrase fast-path in classifier.py misses.

Entries are LISTS of excerpts: n-grams are built per excerpt and
unioned, so no spurious grams span excerpt boundaries.

Subset suppression: several licenses textually contain others
(BSD-3-Clause adds one clause to BSD-2-Clause; ISC is 0BSD plus a
notice-retention condition). After thresholding, candidates are
accepted best-first and a candidate is dropped when >= 90% of its
grams are already covered by an accepted match's grams.
"""

from __future__ import annotations

import re

_N = 5                  # words per gram
_THRESHOLD = 0.9        # ref classifier.go: match.Confidence > 0.9

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def _tokens(text: str) -> list:
    return _TOKEN_RE.findall(text.lower())


def _grams(tokens: list) -> set:
    return {tuple(tokens[i:i + _N])
            for i in range(len(tokens) - _N + 1)}


# license -> list of distinctive excerpts of its operative core.
# Copyright/ownership lines are deliberately absent (they vary per
# project; the containment direction corpus-in-document makes extra
# document text harmless).
_CORPUS_TEXTS = {
    "MIT": [
        "Permission is hereby granted, free of charge, to any "
        "person obtaining a copy of this software and associated "
        "documentation files (the \"Software\"), to deal in the "
        "Software without restriction, including without "
        "limitation the rights to use, copy, modify, merge, "
        "publish, distribute, sublicense, and/or sell copies of "
        "the Software, and to permit persons to whom the Software "
        "is furnished to do so, subject to the following "
        "conditions: The above copyright notice and this "
        "permission notice shall be included in all copies or "
        "substantial portions of the Software.",
        "THE SOFTWARE IS PROVIDED \"AS IS\", WITHOUT WARRANTY OF "
        "ANY KIND, EXPRESS OR IMPLIED, INCLUDING BUT NOT LIMITED "
        "TO THE WARRANTIES OF MERCHANTABILITY, FITNESS FOR A "
        "PARTICULAR PURPOSE AND NONINFRINGEMENT. IN NO EVENT "
        "SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY "
        "CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION "
        "OF CONTRACT, TORT OR OTHERWISE, ARISING FROM, OUT OF OR "
        "IN CONNECTION WITH THE SOFTWARE OR THE USE OR OTHER "
        "DEALINGS IN THE SOFTWARE.",
    ],
    "ISC": [
        "Permission to use, copy, modify, and/or distribute this "
        "software for any purpose with or without fee is hereby "
        "granted, provided that the above copyright notice and "
        "this permission notice appear in all copies.",
        "THE SOFTWARE IS PROVIDED \"AS IS\" AND THE AUTHOR "
        "DISCLAIMS ALL WARRANTIES WITH REGARD TO THIS SOFTWARE "
        "INCLUDING ALL IMPLIED WARRANTIES OF MERCHANTABILITY AND "
        "FITNESS. IN NO EVENT SHALL THE AUTHOR BE LIABLE FOR ANY "
        "SPECIAL, DIRECT, INDIRECT, OR CONSEQUENTIAL DAMAGES OR "
        "ANY DAMAGES WHATSOEVER RESULTING FROM LOSS OF USE, DATA "
        "OR PROFITS, WHETHER IN AN ACTION OF CONTRACT, NEGLIGENCE "
        "OR OTHER TORTIOUS ACTION, ARISING OUT OF OR IN "
        "CONNECTION WITH THE USE OR PERFORMANCE OF THIS SOFTWARE.",
    ],
    "0BSD": [
        "Permission to use, copy, modify, and/or distribute this "
        "software for any purpose with or without fee is hereby "
        "granted.",
        "THE SOFTWARE IS PROVIDED \"AS IS\" AND THE AUTHOR "
        "DISCLAIMS ALL WARRANTIES WITH REGARD TO THIS SOFTWARE "
        "INCLUDING ALL IMPLIED WARRANTIES OF MERCHANTABILITY AND "
        "FITNESS. IN NO EVENT SHALL THE AUTHOR BE LIABLE FOR ANY "
        "SPECIAL, DIRECT, INDIRECT, OR CONSEQUENTIAL DAMAGES OR "
        "ANY DAMAGES WHATSOEVER RESULTING FROM LOSS OF USE, DATA "
        "OR PROFITS, WHETHER IN AN ACTION OF CONTRACT, NEGLIGENCE "
        "OR OTHER TORTIOUS ACTION, ARISING OUT OF OR IN "
        "CONNECTION WITH THE USE OR PERFORMANCE OF THIS SOFTWARE.",
    ],
    "BSD-2-Clause": [
        "Redistribution and use in source and binary forms, with "
        "or without modification, are permitted provided that the "
        "following conditions are met: 1. Redistributions of "
        "source code must retain the above copyright notice, this "
        "list of conditions and the following disclaimer. 2. "
        "Redistributions in binary form must reproduce the above "
        "copyright notice, this list of conditions and the "
        "following disclaimer in the documentation and/or other "
        "materials provided with the distribution.",
        "THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND "
        "CONTRIBUTORS \"AS IS\" AND ANY EXPRESS OR IMPLIED "
        "WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE IMPLIED "
        "WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A "
        "PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE "
        "COPYRIGHT HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY "
        "DIRECT, INDIRECT, INCIDENTAL, SPECIAL, EXEMPLARY, OR "
        "CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO, "
        "PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF "
        "USE, DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER "
        "CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN "
        "CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING "
        "NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE "
        "USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY "
        "OF SUCH DAMAGE.",
    ],
    "BSD-3-Clause": [
        "Redistribution and use in source and binary forms, with "
        "or without modification, are permitted provided that the "
        "following conditions are met: 1. Redistributions of "
        "source code must retain the above copyright notice, this "
        "list of conditions and the following disclaimer. 2. "
        "Redistributions in binary form must reproduce the above "
        "copyright notice, this list of conditions and the "
        "following disclaimer in the documentation and/or other "
        "materials provided with the distribution. 3. Neither the "
        "name of the copyright holder nor the names of its "
        "contributors may be used to endorse or promote products "
        "derived from this software without specific prior "
        "written permission.",
        "THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND "
        "CONTRIBUTORS \"AS IS\" AND ANY EXPRESS OR IMPLIED "
        "WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE IMPLIED "
        "WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A "
        "PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE "
        "COPYRIGHT HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY "
        "DIRECT, INDIRECT, INCIDENTAL, SPECIAL, EXEMPLARY, OR "
        "CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED TO, "
        "PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF "
        "USE, DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER "
        "CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN "
        "CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING "
        "NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE "
        "USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY "
        "OF SUCH DAMAGE.",
    ],
    "BSD-4-Clause": [
        "All advertising materials mentioning features or use of "
        "this software must display the following "
        "acknowledgement: This product includes software "
        "developed by",
        "Redistribution and use in source and binary forms, with "
        "or without modification, are permitted provided that the "
        "following conditions are met: 1. Redistributions of "
        "source code must retain the above copyright notice, this "
        "list of conditions and the following disclaimer.",
    ],
    "Apache-2.0": [
        "\"License\" shall mean the terms and conditions for use, "
        "reproduction, and distribution as defined by Sections 1 "
        "through 9 of this document.",
        "Grant of Copyright License. Subject to the terms and "
        "conditions of this License, each Contributor hereby "
        "grants to You a perpetual, worldwide, non-exclusive, "
        "no-charge, royalty-free, irrevocable copyright license "
        "to reproduce, prepare Derivative Works of, publicly "
        "display, publicly perform, sublicense, and distribute "
        "the Work and such Derivative Works in Source or Object "
        "form.",
        "Redistribution. You may reproduce and distribute copies "
        "of the Work or Derivative Works thereof in any medium, "
        "with or without modifications, and in Source or Object "
        "form, provided that You meet the following conditions:",
    ],
    "GPL-2.0": [
        "The licenses for most software are designed to take away "
        "your freedom to share and change it. By contrast, the "
        "GNU General Public License is intended to guarantee your "
        "freedom to share and change free software--to make sure "
        "the software is free for all its users.",
        "You may copy and distribute verbatim copies of the "
        "Program's source code as you receive it, in any medium, "
        "provided that you conspicuously and appropriately "
        "publish on each copy an appropriate copyright notice and "
        "disclaimer of warranty",
    ],
    "GPL-3.0": [
        "The GNU General Public License is a free, copyleft "
        "license for software and other kinds of works.",
        "When we speak of free software, we are referring to "
        "freedom, not price. Our General Public Licenses are "
        "designed to make sure that you have the freedom to "
        "distribute copies of free software (and charge for them "
        "if you wish), that you receive source code or can get it "
        "if you want it, that you can change the software or use "
        "pieces of it in new free programs, and that you know you "
        "can do these things.",
    ],
    "LGPL-2.1": [
        "This license, the Lesser General Public License, applies "
        "to some specially designated software packages--"
        "typically libraries--of the Free Software Foundation and "
        "other authors who decide to use it.",
        "When we speak of free software, we are referring to "
        "freedom of use, not price.",
    ],
    "LGPL-3.0": [
        "This version of the GNU Lesser General Public License "
        "incorporates the terms and conditions of version 3 of "
        "the GNU General Public License, supplemented by the "
        "additional permissions listed below.",
        "You may convey a covered work under sections 3 and 4 of "
        "this License without being bound by section 3 of the GNU "
        "GPL.",
    ],
    "AGPL-3.0": [
        "The GNU Affero General Public License is a free, "
        "copyleft license for software and other kinds of works, "
        "specifically designed to ensure cooperation with the "
        "community in the case of network server software.",
    ],
    "MPL-2.0": [
        "\"Source Code Form\" means the form of the work "
        "preferred for making modifications.",
        "Each Contributor hereby grants You a world-wide, "
        "royalty-free, non-exclusive license: under intellectual "
        "property rights (other than patent or trademark) "
        "Licensable by such Contributor to use, reproduce, make "
        "available, modify, display, perform, distribute, and "
        "otherwise exploit its Contributions, either on an "
        "unmodified basis, with Modifications, or as part of a "
        "Larger Work;",
    ],
    "Unlicense": [
        "This is free and unencumbered software released into the "
        "public domain. Anyone is free to copy, modify, publish, "
        "use, compile, sell, or distribute this software, either "
        "in source code form or as a compiled binary, for any "
        "purpose, commercial or non-commercial, and by any means.",
        "In jurisdictions that recognize copyright laws, the "
        "author or authors of this software dedicate any and all "
        "copyright interest in the software to the public domain. "
        "We make this dedication for the benefit of the public at "
        "large and to the detriment of our heirs and successors.",
    ],
    "Zlib": [
        "This software is provided 'as-is', without any express "
        "or implied warranty. In no event will the authors be "
        "held liable for any damages arising from the use of this "
        "software. Permission is granted to anyone to use this "
        "software for any purpose, including commercial "
        "applications, and to alter it and redistribute it "
        "freely, subject to the following restrictions: 1. The "
        "origin of this software must not be misrepresented; you "
        "must not claim that you wrote the original software.",
        "2. Altered source versions must be plainly marked as "
        "such, and must not be misrepresented as being the "
        "original software. 3. This notice may not be removed or "
        "altered from any source distribution.",
    ],
    "WTFPL": [
        "Everyone is permitted to copy and distribute verbatim or "
        "modified copies of this license document, and changing "
        "it is allowed as long as the name is changed.",
        "0. You just DO WHAT THE FUCK YOU WANT TO.",
    ],
    "CC0-1.0": [
        "Certain owners wish to permanently relinquish those "
        "rights to a Work for the purpose of contributing to a "
        "commons of creative, cultural and scientific works",
    ],
    "Artistic-2.0": [
        "This license establishes the terms under which a given "
        "free software Package may be copied, modified, "
        "distributed, and/or redistributed.",
    ],
    "BSL-1.0": [
        "Permission is hereby granted, free of charge, to any "
        "person or organization obtaining a copy of the software "
        "and accompanying documentation covered by this license "
        "(the \"Software\") to use, reproduce, display, "
        "distribute, execute, and transmit the Software, and to "
        "prepare derivative works of the Software, and to permit "
        "third-parties to whom the Software is furnished to do "
        "so",
    ],
    "PostgreSQL": [
        "Permission to use, copy, modify, and distribute this "
        "software and its documentation for any purpose, without "
        "fee, and without a written agreement is hereby granted, "
        "provided that the above copyright notice and this "
        "paragraph and the following two paragraphs appear in all "
        "copies.",
    ],
    "OFL-1.1": [
        "Permission is hereby granted, free of charge, to any "
        "person obtaining a copy of the Font Software, to use, "
        "study, copy, merge, embed, modify, redistribute, and "
        "sell modified and unmodified copies of the Font "
        "Software",
    ],
}

_compiled = None


def _corpus():
    """[(name, gramset)] sorted largest-first, built lazily (the
    reference preloads its corpus once too — classifier.go
    initLicenseDB)."""
    global _compiled
    if _compiled is None:
        entries = []
        for name, excerpts in _CORPUS_TEXTS.items():
            grams = set()
            for excerpt in excerpts:
                grams |= _grams(_tokens(excerpt))
            entries.append((name, frozenset(grams)))
        entries.sort(key=lambda e: -len(e[1]))
        _compiled = entries
    return _compiled


def corpus_matches(text: str, threshold: float = _THRESHOLD) -> list:
    """→ [(license, confidence)] for every corpus entry whose grams
    are >= threshold contained in the normalized document, with
    textual-subset candidates suppressed."""
    tokens = _tokens(text)
    if len(tokens) < _N:
        return []
    doc = _grams(tokens)

    candidates = []
    for name, grams in _corpus():
        hit = sum(1 for g in grams if g in doc)
        containment = hit / len(grams)
        if containment >= threshold:
            candidates.append((containment, len(grams), name, grams))
    # Largest entry first: real-world BSD-3 texts substitute an org
    # name into clause 3, scoring slightly below their own corpus
    # entry while the BSD-2 subset still scores 1.0 — specificity
    # must outrank raw containment, then the subset check below
    # drops the contained entry.
    candidates.sort(key=lambda c: (-c[1], -c[0]))

    accepted = []
    out = []
    for containment, _, name, grams in candidates:
        if any(len(grams & prior) / len(grams) >= 0.9
               for prior in accepted):
            continue        # textual subset of a more specific match
        accepted.append(grams)
        out.append((name, round(containment, 2)))
    return out
