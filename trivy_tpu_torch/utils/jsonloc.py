"""Line-aware JSON parsing for lockfile analyzers.

The reference's go-dep-parser records the source line span of each
package entry in package-lock.json (npm Locations in the report).
``parse_with_lines`` parses JSON and returns, alongside the value, a
map from object path (tuple of keys / list indices) to
``(start_line, end_line)`` — start is the line of the member's key (or
of the value for array elements), end is the line of its last token.

Lockfiles are small; a simple recursive-descent parser is plenty.
"""

from __future__ import annotations


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.i = 0
        self.line = 1
        self.spans: dict = {}

    def error(self, msg: str):
        return ValueError(f"line {self.line}: {msg}")

    def _ws(self) -> None:
        t, n = self.text, len(self.text)
        while self.i < n and t[self.i] in " \t\r\n":
            if t[self.i] == "\n":
                self.line += 1
            self.i += 1

    def _expect(self, ch: str) -> None:
        if self.i >= len(self.text) or self.text[self.i] != ch:
            raise self.error(f"expected {ch!r}")
        self.i += 1

    def _string(self) -> str:
        self._expect('"')
        out = []
        t = self.text
        while True:
            if self.i >= len(t):
                raise self.error("unterminated string")
            c = t[self.i]
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                self.i += 1
                if self.i >= len(t):
                    raise self.error("unterminated escape")
                e = t[self.i]
                if e == "u":
                    hexs = t[self.i + 1:self.i + 5]
                    if len(hexs) < 4:
                        raise self.error("truncated \\u escape")
                    try:
                        out.append(chr(int(hexs, 16)))
                    except ValueError:
                        raise self.error("bad \\u escape") from None
                    self.i += 5
                else:
                    out.append({"n": "\n", "t": "\t", "r": "\r",
                                "b": "\b", "f": "\f"}.get(e, e))
                    self.i += 1
            else:
                if c == "\n":
                    self.line += 1
                out.append(c)
                self.i += 1

    def _scalar(self):
        t = self.text
        start = self.i
        while self.i < len(t) and t[self.i] not in ",}] \t\r\n":
            self.i += 1
        tok = t[start:self.i]
        if tok == "true":
            return True
        if tok == "false":
            return False
        if tok == "null":
            return None
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                raise self.error(f"bad token {tok!r}") from None

    def value(self, path: tuple, key_line: int):
        self._ws()
        if self.i >= len(self.text):
            raise self.error("unexpected end of input")
        c = self.text[self.i]
        if c == "{":
            return self._object(path, key_line)
        if c == "[":
            return self._array(path, key_line)
        if c == '"':
            v = self._string()
        else:
            v = self._scalar()
        self.spans[path] = (key_line, self.line)
        return v

    def _object(self, path: tuple, key_line: int) -> dict:
        self._expect("{")
        out: dict = {}
        self._ws()
        if self.i < len(self.text) and self.text[self.i] == "}":
            self.i += 1
            self.spans[path] = (key_line, self.line)
            return out
        while True:
            self._ws()
            k_line = self.line
            k = self._string()
            self._ws()
            self._expect(":")
            out[k] = self.value(path + (k,), k_line)
            self._ws()
            if self.i < len(self.text) and self.text[self.i] == ",":
                self.i += 1
                continue
            self._expect("}")
            self.spans[path] = (key_line, self.line)
            return out

    def _array(self, path: tuple, key_line: int) -> list:
        self._expect("[")
        out: list = []
        self._ws()
        if self.i < len(self.text) and self.text[self.i] == "]":
            self.i += 1
            self.spans[path] = (key_line, self.line)
            return out
        while True:
            self._ws()
            out.append(self.value(path + (len(out),), self.line))
            self._ws()
            if self.i < len(self.text) and self.text[self.i] == ",":
                self.i += 1
                continue
            self._expect("]")
            self.spans[path] = (key_line, self.line)
            return out


def parse_with_lines(data) -> tuple:
    """``data``: bytes or str. Returns (value, spans) where spans maps
    path tuples to (start_line, end_line), 1-based inclusive."""
    if isinstance(data, bytes):
        data = data.decode("utf-8", "replace")
    p = _Parser(data)
    v = p.value((), 1)
    return v, p.spans
