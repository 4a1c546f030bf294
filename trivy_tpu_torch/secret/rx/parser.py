"""Recursive-descent parser for the regex subset used by secret rules.

Supported syntax (the RE2/Python common subset the builtin rules use):
  literals, escapes, char classes (ranges, negation), ``.``, anchors,
  ``\\b``/``\\B``, groups ``(...)`` / ``(?:...)`` / ``(?P<name>...)``,
  alternation, quantifiers ``* + ? {m} {m,} {m,n}`` (incl. lazy forms),
  global ``(?i)``/``(?s)`` prefix flags and scoped ``(?i:...)`` groups.

The AST is built directly over byte sets so case folding and sieve
construction are trivial downstream. Anchors/word-boundaries parse into
``Boundary`` nodes; the anchor analysis treats them as ε
(over-approximation — see package docstring).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

ALL_BYTES = frozenset(range(256))
_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) +
    list(range(0x61, 0x7B)) + [0x5F])
_SPACE = frozenset(b" \t\n\r\f\v")


class RegexParseError(ValueError):
    pass


# ---- AST ----

@dataclass
class Lit:
    """One input unit drawn from a byte set.

    ``ascii_only=True`` means the unit is exactly one ASCII byte in
    the *decoded-text* regex too (explicit literals, explicit classes
    and ranges). Shorthand escapes (``\\d \\w \\s`` and negations),
    ``.`` and negated classes are Unicode-aware when the rule regex
    runs over str — one unit can consume up to 4 UTF-8 bytes — and
    carry ``ascii_only=False`` so byte-window math can account for it.
    """
    bytes: frozenset
    ascii_only: bool = True


@dataclass
class Cat:
    parts: list


@dataclass
class Alt:
    options: list


@dataclass
class Rep:
    node: "Node"
    min: int
    max: Optional[int]  # None = unbounded


@dataclass
class Boundary:
    """Zero-width assertion: ^ $ \\b \\B — treated as ε downstream."""
    kind: str


@dataclass
class Empty:
    pass


Node = Union[Lit, Cat, Alt, Rep, Boundary, Empty]


def _fold_case(bs: frozenset) -> frozenset:
    out = set(bs)
    for b in bs:
        if 0x41 <= b <= 0x5A:
            out.add(b + 0x20)
        elif 0x61 <= b <= 0x7A:
            out.add(b - 0x20)
    return frozenset(out)


@dataclass
class _Flags:
    icase: bool = False
    dotall: bool = False

    def clone(self) -> "_Flags":
        return _Flags(self.icase, self.dotall)


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.n = len(pattern)

    # -- stream helpers --

    def peek(self) -> str:
        return self.p[self.i] if self.i < self.n else ""

    def next(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def expect(self, c: str) -> None:
        if self.next() != c:
            raise RegexParseError(
                f"expected {c!r} at {self.i} in {self.p!r}")

    # -- grammar --

    def parse(self) -> Node:
        flags = _Flags()
        # Global flag prefix(es): (?i) (?s) (?is)
        while self.p.startswith("(?", self.i):
            j = self.i + 2
            seen = set()
            while j < self.n and self.p[j] in "is":
                seen.add(self.p[j])
                j += 1
            if j < self.n and self.p[j] == ")" and seen:
                flags.icase |= "i" in seen
                flags.dotall |= "s" in seen
                self.i = j + 1
            else:
                break
        node = self.alt(flags)
        if self.i != self.n:
            raise RegexParseError(
                f"trailing input at {self.i} in {self.p!r}")
        return node

    def alt(self, flags: _Flags) -> Node:
        opts = [self.cat(flags)]
        while self.peek() == "|":
            self.next()
            opts.append(self.cat(flags))
        return opts[0] if len(opts) == 1 else Alt(opts)

    def cat(self, flags: _Flags) -> Node:
        parts = []
        while self.peek() not in ("", "|", ")"):
            parts.append(self.quantified(flags))
        if not parts:
            return Empty()
        return parts[0] if len(parts) == 1 else Cat(parts)

    def quantified(self, flags: _Flags) -> Node:
        atom = self.atom(flags)
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                atom = Rep(atom, 0, None)
            elif c == "+":
                self.next()
                atom = Rep(atom, 1, None)
            elif c == "?":
                self.next()
                atom = Rep(atom, 0, 1)
            elif c == "{":
                save = self.i
                rep = self._counted()
                if rep is None:
                    self.i = save
                    break
                lo, hi = rep
                atom = Rep(atom, lo, hi)
            else:
                break
            if self.peek() == "?":  # lazy — same language
                self.next()
        return atom

    def _counted(self) -> Optional[tuple]:
        # '{m}' '{m,}' '{m,n}' — otherwise a literal '{'
        self.expect("{")
        digits = ""
        while self.peek().isdigit():
            digits += self.next()
        if not digits:
            return None
        lo = int(digits)
        hi: Optional[int] = lo
        if self.peek() == ",":
            self.next()
            digits2 = ""
            while self.peek().isdigit():
                digits2 += self.next()
            hi = int(digits2) if digits2 else None
        if self.peek() != "}":
            return None
        self.next()
        return lo, hi

    def atom(self, flags: _Flags) -> Node:
        c = self.next()
        if c == "(":
            return self.group(flags)
        if c == "[":
            return self.char_class(flags)
        if c == ".":
            bs = ALL_BYTES if flags.dotall else ALL_BYTES - {0x0A}
            return Lit(frozenset(bs), ascii_only=False)
        if c == "^":
            return Boundary("^")
        if c == "$":
            return Boundary("$")
        if c == "\\":
            return self.escape(flags)
        if c in "*+?":
            raise RegexParseError(f"dangling quantifier in {self.p!r}")
        return self._lit(ord(c), flags)

    def _lit(self, b: int, flags: _Flags) -> Lit:
        if b >= 0x80:
            # a non-ASCII literal char is 1 unit but 2-4 bytes in the
            # str regex; modelling it as one byte corrupts the window
            # math — reject, the rule host-falls-back
            raise RegexParseError(
                f"non-ASCII literal U+{b:04X} in {self.p!r}")
        bs = frozenset([b])
        if flags.icase:
            bs = _fold_case(bs)
        return Lit(bs)

    def group(self, flags: _Flags) -> Node:
        inner_flags = flags.clone()
        if self.peek() == "?":
            self.next()
            c = self.next()
            if c == ":":
                pass
            elif c == "P":
                self.expect("<")
                while self.peek() not in ("", ">"):
                    self.next()
                self.expect(">")
            elif c == "<":  # (?<name>...) RE2-style named group
                while self.peek() not in ("", ">"):
                    self.next()
                self.expect(">")
            elif c in "is":
                seen = {c}
                while self.peek() in "is":
                    seen.add(self.next())
                inner_flags.icase |= "i" in seen
                inner_flags.dotall |= "s" in seen
                nc = self.next()
                if nc == ")":
                    # (?i) mid-pattern: RE2 applies to the rest; we apply
                    # to the rest of the current alternation scope.
                    rest = self.alt(inner_flags)
                    return rest
                if nc != ":":
                    raise RegexParseError(
                        f"unsupported group flags at {self.i}")
            else:
                raise RegexParseError(
                    f"unsupported group (?{c} in {self.p!r}")
        node = self.alt(inner_flags)
        self.expect(")")
        return node

    def escape(self, flags: _Flags) -> Node:
        c = self.next()
        if c == "":
            raise RegexParseError("trailing backslash")
        table = {
            "d": _DIGITS, "D": ALL_BYTES - _DIGITS,
            "w": _WORD, "W": ALL_BYTES - _WORD,
            "s": _SPACE, "S": ALL_BYTES - _SPACE,
        }
        if c in table:
            return Lit(frozenset(table[c]), ascii_only=False)
        if c == "b":
            return Boundary("b")
        if c == "B":
            return Boundary("B")
        simple = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C,
                  "v": 0x0B, "a": 0x07, "0": 0x00}
        if c in simple:
            return Lit(frozenset([simple[c]]))
        if c == "x":
            h = self.next() + self.next()
            return self._lit(int(h, 16), flags)
        # escaped metachar / punctuation: literal byte
        return self._lit(ord(c), flags)

    def char_class(self, flags: _Flags) -> Lit:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        members: set = set()
        unicode_aware = negate      # [^…] matches multibyte chars too
        first = True
        while True:
            c = self.peek()
            if c == "":
                raise RegexParseError(f"unterminated class in {self.p!r}")
            if c == "]" and not first:
                self.next()
                break
            first = False
            atom = self._class_atom(members)
            if atom is None:  # \d etc.: already merged into members
                unicode_aware = True
                continue
            if self.peek() == "-" and self.i + 1 < self.n and \
                    self.p[self.i + 1] != "]":
                self.next()
                hi = self._class_atom(members)
                if hi is None or len(atom) != 1 or len(hi) != 1:
                    raise RegexParseError(f"bad range in {self.p!r}")
                a, b = min(atom), min(hi)
                if a > b:
                    raise RegexParseError("reversed range")
                members.update(range(a, b + 1))
            else:
                members.update(atom)
        if any(m >= 0x80 for m in members):
            raise RegexParseError(
                f"non-ASCII class member in {self.p!r}")
        bs = frozenset(members)
        if negate:
            bs = ALL_BYTES - bs
        if flags.icase:
            bs = _fold_case(bs)
        return Lit(bs, ascii_only=not unicode_aware)

    def _class_atom(self, members: set) -> Optional[frozenset]:
        """One class member. Multi-byte escapes (\\d …) merge straight
        into ``members`` and return None (they can't head a range)."""
        c = self.next()
        if c != "\\":
            return frozenset([ord(c)])
        e = self.next()
        table = {
            "d": _DIGITS, "D": ALL_BYTES - _DIGITS,
            "w": _WORD, "W": ALL_BYTES - _WORD,
            "s": _SPACE, "S": ALL_BYTES - _SPACE,
        }
        if e in table:
            members.update(table[e])
            return None
        simple = {"n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C,
                  "v": 0x0B, "a": 0x07, "0": 0x00}
        if e in simple:
            return frozenset([simple[e]])
        if e == "x":
            return frozenset([int(self.next() + self.next(), 16)])
        return frozenset([ord(e)])


def parse(pattern: str) -> Node:
    return _Parser(pattern).parse()
