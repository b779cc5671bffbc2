"""A reader for the YAML subset of ``newsreclib_tpu/configs/`` (the card
machine has no yaml package).

``loads(text)`` gives what ``yaml.safe_load(text)`` gives for:

* block mappings and block sequences, a sequence allowed at its parent
  key's indentation, a mapping allowed to start on a ``- `` line;
* flow sequences and flow mappings on one line (``[5, 10]``,
  ``{low: 1.0e-5, log: true}``), nested;
* plain, single-quoted and double-quoted scalars on one line; comments;
* pyyaml's YAML 1.1 scalar rules: ``null`` / ``~`` / empty, the eleven
  spellings of each boolean (``yes``, ``On``, ...), decimal, octal
  (``017``), hex, binary and base-60 integers, and floats only with a dot
  and a signed exponent, so a bare ``1e-4`` stays the string ``'1e-4'``.

Anything else (anchors, tags, multi-line scalars, unquoted timestamps,
several documents) raises ``ValueError`` rather than being read otherwise.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# a quote opens a quoted scalar only where a scalar can start
_SCALAR_START = ":-[{,"


def _sexagesimal(value: str, cast) -> Any:
    total = 0
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar under pyyaml's YAML 1.1 resolver."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if text == "<<" or text == "=":
        raise ValueError(f"YAML merge / value keys are not supported: {text!r}")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"unquoted YAML timestamps are not supported: {text!r}")
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML syntax: {text!r}")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` and the index past it."""
    quote = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if quote == "'":
            if c == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), j + 1
            if c == "\\":
                e = text[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(text[j + 2:j + 2 + n], 16)))
                    j += 2 + n
                    continue
                raise ValueError(f"unsupported escape in {text!r}")
            out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar (multi-line scalars are not supported): {text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a blank,
    outside quoted scalars."""
    i, prev = 0, ""
    while i < len(line):
        c = line[i]
        if c in "'\"" and (not prev.strip() or prev.rstrip()[-1:] in _SCALAR_START):
            _, i = _quoted(line, i)
            prev = line[:i]
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
        prev = line[:i]
    return line


def _key_split(text: str):
    """``(key, rest)`` if ``text`` is a ``key: value`` line, else None."""
    i = 0
    if text[:1] in "'\"":
        _, i = _quoted(text, 0)
    depth = 0
    while i < len(text):
        c = text[i]
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in " \t"):
            return text[:i].rstrip(), text[i + 1:].strip()
        i += 1
    return None


def _key(text: str) -> Any:
    if text[:1] in "'\"":
        value, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"bad mapping key: {text!r}")
        return value
    return resolve_plain(text)


class _Flow:
    """Parser of one flow node (``[...]``, ``{...}`` or a scalar)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, in_map: bool = False) -> Any:
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            value, self.i = _quoted(self.s, self.i)
            return value
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",]}" or (in_map and c == ":" and self.s[self.i + 1:self.i + 2] in (" ", "")):
                break
            if c in "[{":
                raise ValueError(f"unsupported flow syntax: {self.s!r}")
            self.i += 1
        return resolve_plain(self.s[start:self.i].strip())

    def _expect(self, chars: str) -> str:
        self._ws()
        c = self.s[self.i:self.i + 1]
        if not c or c not in chars:
            raise ValueError(f"expected one of {chars!r} at {self.i} in {self.s!r}")
        self.i += 1
        return c

    def _seq(self) -> list:
        self.i += 1
        out: list = []
        self._ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.node())
            if self._expect(",]") == "]":
                return out
            self._ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out

    def _map(self) -> dict:
        self.i += 1
        out: dict = {}
        self._ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.node(in_map=True)
            self._expect(":")
            self._ws()
            out[key] = None if self.s[self.i:self.i + 1] in (",", "}") else self.node(in_map=True)
            if self._expect(",}") == "}":
                return out
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out


def _inline(text: str) -> Any:
    """A node written on one line after ``key:`` or ``-``."""
    if text[:1] in "[{'\"":
        parser = _Flow(text)
        value = parser.node()
        if text[parser.i:].strip():
            raise ValueError(f"trailing text after a node: {text!r}")
        return value
    return resolve_plain(text)


def _lines(text: str) -> List[List]:
    out = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "...") and not raw[:1].isspace():
            raise ValueError("YAML document markers are not supported")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"tab in indentation: {raw!r}")
        out.append([len(line) - len(line.lstrip(" ")), line.strip()])
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: List[List], i: int, indent: int) -> Tuple[Any, int]:
    text = lines[i][1]
    if _is_item(text):
        return _seq(lines, i, indent)
    if _key_split(text) is not None:
        return _map(lines, i, indent)
    return _inline(text), i + 1


def _nested(lines: List[List], i: int, indent: int, seq_here: bool) -> Tuple[Any, int]:
    """The block under a ``key:`` / ``-`` with nothing after it: lines
    indented deeper (or, under a key, a sequence at the key's indentation)."""
    if i < len(lines) and (lines[i][0] > indent or (seq_here and lines[i][0] == indent
                                                    and _is_item(lines[i][1]))):
        return _block(lines, i, lines[i][0])
    return None, i


def _map(lines: List[List], i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        split = _key_split(lines[i][1])
        if split is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = split
        i += 1
        if rest:
            out[_key(key)] = _inline(rest)
        else:
            out[_key(key)], i = _nested(lines, i, indent, seq_here=True)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i


def _seq(lines: List[List], i: int, indent: int) -> Tuple[list, int]:
    out: list = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        text = lines[i][1]
        rest = text[1:].lstrip(" ")
        if not rest:
            value, i = _nested(lines, i + 1, indent, seq_here=False)
        elif _is_item(rest) or (rest[:1] not in "[{" and _key_split(rest) is not None):
            # a nested block that starts on the item's line
            lines[i] = [indent + len(text) - len(rest), rest]
            value, i = _block(lines, i, lines[i][0])
        else:
            value, i = _inline(rest), i + 1
        out.append(value)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return out, i


def loads(text: str) -> Any:
    """``yaml.safe_load(text)`` for the subset in the module doc."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected line {lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
