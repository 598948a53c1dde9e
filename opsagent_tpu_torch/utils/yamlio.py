"""A YAML reader and writer for the subset the agent reads and writes,
without PyYAML (the machine beside the card has none).

The agent reads YAML in three places (kubeconfig files, multi-document
manifests to apply, ``configs/config.yaml``) and writes it in two (a live
object rendered for the analysis prompt, a manifest sent to server-side
apply). Both sides follow PyYAML's safe loader and dumper, because the
rendered text enters a prompt and a changed byte changes the transcript:

- ``safe_dump(obj, sort_keys=True, allow_unicode=False)`` gives the bytes of
  ``yaml.safe_dump`` with the same arguments, for dicts, lists, strings,
  ints, floats, bools and None: block style, empty collections as ``{}`` and
  ``[]``, plain scalars where they read back as the same string, else single
  quotes, else double quotes with escapes, and long scalars folded at 80
  columns as PyYAML's emitter folds them. A key must be a scalar of one line
  under 128 characters (PyYAML writes anything else as a complex key, which
  this writer refuses).
- ``safe_load`` / ``safe_load_all`` give what ``yaml.safe_load`` /
  ``safe_load_all`` give for block mappings and sequences (sequences in a
  mapping indented or not), plain, single- and double-quoted scalars (multi
  line included, folded as YAML folds them), ``|`` and ``>`` block scalars
  with their chomping and indentation indicators, comments, ``---`` / ``...``
  document streams, and flow ``[...]`` / ``{...}`` collections. Plain scalars
  resolve by YAML 1.1's rules as PyYAML's do: null, bool (``yes``/``on``
  too), int (``0x``, ``0b``, a leading 0 for octal, ``_``, base 60), float,
  timestamp. Anchors, aliases, tags and complex (``?``) keys raise
  ``YAMLError``.
"""

from __future__ import annotations

import datetime
import math
import re
from typing import Any, Iterator


class YAMLError(ValueError):
    """Input outside the supported subset, or not YAML."""


# -- implicit resolution (YAML 1.1, as PyYAML's resolver) -----------------------
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_TS_PARTS = re.compile(
    r"^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)"
    r"(?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9])"
    r":(?P<second>[0-9][0-9])(?:\.(?P<fraction>[0-9]*))?"
    r"(?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)"
    r"(?::(?P<tz_minute>[0-9][0-9]))?))?)?$")

# First characters each resolver looks at, in PyYAML's registration order.
_RESOLVERS = (
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", _NULL, "~nN"),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)


def _resolve(value: str) -> str:
    """The tag a plain scalar resolves to: ``str`` unless an implicit
    resolver for its first character matches."""
    if value == "":
        return "null"
    for tag, regex, first in _RESOLVERS:
        if value[0] in first and regex.match(value):
            return tag
    return "str"


def _sexagesimal(value: str, cast) -> Any:
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return sign * out


def _construct_int(value: str) -> int:
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


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _construct_timestamp(value: str) -> datetime.date | datetime.datetime:
    m = _TS_PARTS.match(value)
    if m is None:
        raise YAMLError(f"bad timestamp {value!r}")
    year, month, day = int(m["year"]), int(m["month"]), int(m["day"])
    if not m["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if m["fraction"]:
        fraction = int(m["fraction"][:6].ljust(6, "0"))
    tz = None
    if m["tz_sign"]:
        delta = datetime.timedelta(hours=int(m["tz_hour"]), minutes=int(m["tz_minute"] or 0))
        if m["tz_sign"] == "-":
            delta = -delta
        tz = datetime.timezone(delta)
    elif m["tz"]:
        tz = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(m["hour"]), int(m["minute"]),
                             int(m["second"]), fraction, tzinfo=tz)


def _plain_value(text: str) -> Any:
    tag = _resolve(text)
    if tag == "null":
        return None
    if tag == "bool":
        return text.lower() in ("yes", "true", "on")
    if tag == "int":
        return _construct_int(text)
    if tag == "float":
        return _construct_float(text)
    if tag == "timestamp":
        return _construct_timestamp(text)
    if tag == "merge":
        raise YAMLError("merge keys (<<) are not supported")
    return text


# -- writer -------------------------------------------------------------------
_BREAKS = "\n\x85\u2028\u2029"
_WS = "\0 \t\r" + _BREAKS
_ESCAPES = {
    "\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n", "\x0B": "v",
    "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"', "\\": "\\", "\x85": "N",
    "\xA0": "_", "\u2028": "L", "\u2029": "P",
}


class _Analysis:
    __slots__ = ("empty", "multiline", "flow_plain", "block_plain", "single_quoted")

    def __init__(self, scalar: str, allow_unicode: bool):
        self.empty = not scalar
        if not scalar:
            self.multiline = False
            self.flow_plain, self.block_plain, self.single_quoted = False, True, True
            return
        block_ind = flow_ind = scalar.startswith("---") or scalar.startswith("...")
        line_breaks = special = False
        lead_space = lead_break = trail_space = trail_break = False
        break_space = space_break = False
        preceded_ws = True
        followed_ws = len(scalar) == 1 or scalar[1] in _WS
        prev_space = prev_break = False
        n = len(scalar)
        for i, ch in enumerate(scalar):
            if i == 0:
                if ch in "#,[]{}&*!|>'\"%@`":
                    flow_ind = block_ind = True
                if ch in "?:":
                    flow_ind = True
                    if followed_ws:
                        block_ind = True
                if ch == "-" and followed_ws:
                    flow_ind = block_ind = True
            else:
                if ch in ",?[]{}":
                    flow_ind = True
                if ch == ":":
                    flow_ind = True
                    if followed_ws:
                        block_ind = True
                if ch == "#" and preceded_ws:
                    flow_ind = block_ind = True
            if ch in _BREAKS:
                line_breaks = True
            if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
                if (ch == "\x85" or "\xA0" <= ch <= "\uD7FF" or "\uE000" <= ch <= "\uFFFD"
                        or "\U00010000" <= ch < "\U0010ffff") and ch != "\uFEFF":
                    if not allow_unicode:
                        special = True
                else:
                    special = True
            if ch == " ":
                if i == 0:
                    lead_space = True
                if i == n - 1:
                    trail_space = True
                if prev_break:
                    break_space = True
                prev_space, prev_break = True, False
            elif ch in _BREAKS:
                if i == 0:
                    lead_break = True
                if i == n - 1:
                    trail_break = True
                if prev_space:
                    space_break = True
                prev_space, prev_break = False, True
            else:
                prev_space = prev_break = False
            preceded_ws = ch in _WS
            followed_ws = i + 2 >= n or scalar[i + 2] in _WS
        flow_plain = block_plain = single = True
        if lead_space or lead_break or trail_space or trail_break:
            flow_plain = block_plain = False
        if break_space:
            flow_plain = block_plain = single = False
        if space_break or special:
            flow_plain = block_plain = single = False
        if line_breaks:
            flow_plain = block_plain = False
        if flow_ind:
            flow_plain = False
        if block_ind:
            block_plain = False
        self.multiline = line_breaks
        self.flow_plain, self.block_plain, self.single_quoted = flow_plain, block_plain, single


def _represent(value: Any) -> tuple[str, bool]:
    """(text, plain-implicit): whether the text read back plain is
    ``value`` again."""
    if value is None:
        return "null", True
    if value is True:
        return "true", True
    if value is False:
        return "false", True
    if isinstance(value, int):
        return str(value), True
    if isinstance(value, float):
        if value != value:
            return ".nan", True
        if value == math.inf:
            return ".inf", True
        if value == -math.inf:
            return "-.inf", True
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, True
    if isinstance(value, str):
        return value, _resolve(value) == "str"
    raise YAMLError(f"cannot represent an object of type {type(value).__name__}")


class _Emitter:
    """PyYAML's emitter state (column, whitespace, indention, the indent
    stack) for block collections and flow-style scalars."""

    BEST_WIDTH = 80
    BEST_INDENT = 2

    def __init__(self, sort_keys: bool, allow_unicode: bool):
        self.sort_keys = sort_keys
        self.allow_unicode = allow_unicode
        self.out: list[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.open_ended = False
        self.indent: int | None = None
        self.indents: list[int | None] = []
        self.flow_level = 0
        self.root = self.mapping_ctx = self.simple_key = False

    # -- low level writes
    def _write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, ind: str, need_ws: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        self._write(ind if self.whitespace or not need_ws else " " + ind)
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False

    def line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append(data)

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self._write(" " * (indent - self.column))

    def increase_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = self.BEST_INDENT if flow else 0
        elif not indentless:
            self.indent += self.BEST_INDENT

    # -- nodes
    def node(self, value: Any, root: bool = False, sequence: bool = False,
             mapping: bool = False, simple_key: bool = False) -> None:
        self.root, self.mapping_ctx, self.simple_key = root, mapping, simple_key
        if isinstance(value, dict):
            if not value:
                self._empty("{", "}")
            else:
                self._mapping(value)
        elif isinstance(value, list):
            if not value:
                self._empty("[", "]")
            else:
                self._sequence(value)
        else:
            self.increase_indent(flow=True)
            self._scalar(value)
            self.indent = self.indents.pop()

    def _empty(self, open_: str, close: str) -> None:
        self.indicator(open_, True, whitespace=True)
        self.indicator(close, False)

    def _mapping(self, value: dict) -> None:
        self.increase_indent()
        items = list(value.items())
        if self.sort_keys:
            try:
                items = sorted(items)
            except TypeError:
                pass
        for k, v in items:
            self.write_indent()
            text, _ = _represent(k)
            a = _Analysis(text, self.allow_unicode)
            if isinstance(k, (dict, list)) or len(text) >= 128 or a.empty or a.multiline:
                raise YAMLError(f"key {k!r} would need a complex key")
            self.node(k, mapping=True, simple_key=True)
            self.indicator(":", False)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()

    def _sequence(self, value: list) -> None:
        self.increase_indent(indentless=self.mapping_ctx and not self.indention)
        for item in value:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item, sequence=True)
        self.indent = self.indents.pop()

    def _scalar(self, value: Any) -> None:
        text, implicit = _represent(value)
        a = _Analysis(text, self.allow_unicode)
        split = not self.simple_key
        if (implicit and not (self.simple_key and (a.empty or a.multiline))
                and (a.flow_plain if self.flow_level else a.block_plain)):
            self._plain(text, split)
        elif a.single_quoted and not (self.simple_key and a.multiline):
            self._single_quoted(text, split)
        else:
            self._double_quoted(text, split)

    def _plain(self, text: str, split: bool) -> None:
        if self.root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self._write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > self.BEST_WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self._write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self._breaks(text, start, end)
                    self.write_indent()
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self._write(text[start:end])
                start = end
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1

    def _breaks(self, text: str, start: int, end: int) -> None:
        if text[start] == "\n":
            self.line_break()
        for br in text[start:end]:
            self.line_break("\n" if br == "\n" else br)

    def _single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > self.BEST_WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self._write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self._breaks(text, start, end)
                    self.write_indent()
                    start = end
            elif ch is None or ch in " " + _BREAKS or ch == "'":
                if start < end:
                    self._write(text[start:end])
                    start = end
            if ch == "'":
                self._write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1
        self.indicator("'", False)

    def _double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\uFEFF' or not (
                    "\x20" <= ch <= "\x7E" or (self.allow_unicode and (
                        "\xA0" <= ch <= "\uD7FF" or "\uE000" <= ch <= "\uFFFD"))):
                if start < end:
                    self._write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        data = "\\" + _ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self._write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > self.BEST_WIDTH and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self._write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self._write("\\")
            end += 1
        self.indicator('"', False)

    def document(self, value: Any) -> str:
        """The stream of one document: the node, and ``...`` after a plain
        root scalar (it would run on into a next document)."""
        self.node(value, root=True)
        self.write_indent()
        if self.open_ended:
            self.indicator("...", True)
            self.write_indent()
        return "".join(self.out)


def safe_dump(data: Any, sort_keys: bool = True, allow_unicode: bool = False) -> str:
    """``yaml.safe_dump(data, sort_keys=..., allow_unicode=...)``."""
    return _Emitter(sort_keys, allow_unicode).document(data)


# -- reader -------------------------------------------------------------------
_UNESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A",
    "v": "\x0B", "f": "\x0C", "r": "\x0D", "e": "\x1B", " ": " ", '"': '"',
    "/": "/", "\\": "\\", "N": "\x85", "_": "\xA0", "L": "\u2028", "P": "\u2029",
}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


def _line_break(ch: str) -> str:
    """What a line break reads as: NEL as a newline, the Unicode line and
    paragraph separators as themselves."""
    return ch if ch in "\u2028\u2029" else "\n"


def _scan_quoted(s: str, i: int, where: str) -> tuple[str, int]:
    """The quoted scalar opening at ``s[i]`` (lines joined by ``\\n``):
    (its value, the index past the closing quote), folded as YAML folds a
    flow scalar's line breaks."""
    quote = s[i]
    double = quote == '"'
    i += 1
    chunks: list[str] = []
    n = len(s)

    def breaks_from(j: int) -> tuple[list[str], int]:
        # After a line break: the breaks of the blank lines that follow,
        # with each line's leading blanks skipped.
        out = []
        while True:
            while j < n and s[j] in " \t":
                j += 1
            if j < n and s[j] in _BREAKS:
                out.append(_line_break(s[j]))
                j += 1
            else:
                return out, j

    while True:
        if i >= n:
            raise YAMLError(f"unterminated quoted scalar {where}")
        ch = s[i]
        if not double and ch == "'":
            if i + 1 < n and s[i + 1] == "'":
                chunks.append("'")
                i += 2
                continue
            return "".join(chunks), i + 1
        if double and ch == '"':
            return "".join(chunks), i + 1
        if double and ch == "\\":
            if i + 1 >= n:
                raise YAMLError(f"unterminated quoted scalar {where}")
            nxt = s[i + 1]
            if nxt in _UNESCAPES:
                chunks.append(_UNESCAPES[nxt])
                i += 2
            elif nxt in _HEX_LEN:
                k = _HEX_LEN[nxt]
                code = s[i + 2:i + 2 + k]
                if len(code) != k or not all(c in "0123456789abcdefABCDEF" for c in code):
                    raise YAMLError(f"bad escape \\{nxt}{code} {where}")
                chunks.append(chr(int(code, 16)))
                i += 2 + k
            elif nxt in _BREAKS:
                br, i = breaks_from(i + 2)
                chunks.extend(br)
            else:
                raise YAMLError(f"unknown escape \\{nxt} {where}")
            continue
        if ch in " \t":
            j = i
            while j < n and s[j] in " \t":
                j += 1
            if j >= n or s[j] not in _BREAKS:
                chunks.append(s[i:j])
            i = j
            continue
        if ch in _BREAKS:
            br, i = breaks_from(i + 1)
            if _line_break(ch) != "\n":
                chunks.append(ch)
            elif not br:
                chunks.append(" ")
            chunks.extend(br)
            continue
        chunks.append(ch)
        i += 1


def _strip_comment(text: str) -> str:
    """``text`` without a trailing `` #`` comment, outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip(" \t")
    return text.rstrip(" \t")


def _plain_end(text: str) -> int:
    """Where a block-context plain scalar on this line ends: at a comment
    (``#`` after a blank) or the line's end."""
    for i, ch in enumerate(text):
        if ch == "#" and i > 0 and text[i - 1] in " \t":
            return i
    return len(text)


class _Flow:
    """A flow collection over a string (lines joined by blanks)."""

    def __init__(self, s: str, where: str):
        self.s, self.i, self.where = s, 0, where

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t\n":
            self.i += 1

    def node(self) -> Any:
        self.ws()
        ch = self.s[self.i] if self.i < len(self.s) else ""
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        if ch in "'\"":
            value, self.i = _scan_quoted(self.s, self.i, self.where)
            return value
        if ch in "&*!?":
            raise YAMLError(f"anchors, aliases, tags and complex keys are not supported {self.where}")
        return _plain_value(self.plain())

    def plain(self) -> str:
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in ",[]{}":
                break
            if ch == ":" and (self.i + 1 >= len(self.s) or self.s[self.i + 1] in " \t\n,[]{}"):
                break
            self.i += 1
        return re.sub(r"[ \t]*\n[ \t]*", " ", self.s[start:self.i]).strip(" \t\n")

    def expect(self, ch: str) -> None:
        self.ws()
        if self.i >= len(self.s) or self.s[self.i] != ch:
            raise YAMLError(f"expected {ch!r} in a flow collection {self.where}")
        self.i += 1

    def seq(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.node())
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ":":
                raise YAMLError(f"single-pair mappings in a flow sequence are not supported {self.where}")
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            else:
                self.expect("]")
                return out

    def map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.node()
            self.ws()
            value = None
            if self.i < len(self.s) and self.s[self.i] == ":":
                self.i += 1
                self.ws()
                if self.i < len(self.s) and self.s[self.i] not in ",}":
                    value = self.node()
            out[key] = value
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            else:
                self.expect("}")
                return out


def _indent_of(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


class _Block:
    """Block nodes over one document's lines."""

    def __init__(self, lines: list[str], first_line: int):
        self.lines = lines
        self.first = first_line
        self.i = 0

    def where(self, k: int | None = None) -> str:
        return f"(line {self.first + (self.i if k is None else k) + 1})"

    def content(self) -> bool:
        """Skip blank and comment lines; True while a content line is left."""
        while self.i < len(self.lines):
            s = self.lines[self.i].strip(" \t")
            if s and not s.startswith("#"):
                return True
            self.i += 1
        return False

    def node(self, parent: int) -> Any:
        """The node whose first line is indented past ``parent``, or None."""
        if not self.content():
            return None
        line = self.lines[self.i]
        ind = _indent_of(line)
        if ind <= parent:
            return None
        if "\t" in line[:ind + 1] and line[ind:ind + 1] == "\t":
            raise YAMLError(f"tab indentation {self.where()}")
        text = line[ind:]
        if text == "-" or text.startswith("- ") or text.startswith("-\t"):
            return self.sequence(ind)
        if self.key_split(text) is not None:
            return self.mapping(ind)
        return self.value(text, ind, parent, key_line=False)

    def sequence(self, ind: int) -> list:
        out = []
        while self.content() and _indent_of(self.lines[self.i]) == ind:
            text = self.lines[self.i][ind:]
            if not (text == "-" or text.startswith("- ") or text.startswith("-\t")):
                break
            rest = text[1:]
            if not rest.strip(" \t") or rest.strip(" \t").startswith("#"):
                self.i += 1
                out.append(self.node(ind))
            else:
                # The item's content starts on this line: re-read the line
                # with the dash blanked, its content at its own column.
                self.lines[self.i] = " " * (ind + 1) + rest
                out.append(self.node(ind))
        return out

    def key_split(self, text: str) -> tuple[Any, str] | None:
        """(key, the text after ``:``) when ``text`` opens a mapping entry."""
        if text.startswith("? ") or text == "?":
            raise YAMLError(f"complex keys are not supported {self.where()}")
        if text[0] in "'\"":
            try:
                key, j = _scan_quoted(text, 0, self.where())
            except YAMLError:
                return None
            rest = text[j:].lstrip(" \t")
            if rest == ":" or rest.startswith(": ") or rest.startswith(":\t"):
                return key, rest[1:].strip(" \t")
            return None
        if text[0] in "[{&*!|>%@`#":
            return None
        end = _plain_end(text)
        for j in range(end):
            if text[j] == ":" and (j + 1 == end or text[j + 1] in " \t"):
                return _plain_value(text[:j].rstrip(" \t")), text[j + 1:].strip(" \t")
        return None

    def mapping(self, ind: int) -> dict:
        out: dict = {}
        while self.content() and _indent_of(self.lines[self.i]) == ind:
            text = self.lines[self.i][ind:]
            split = self.key_split(text)
            if split is None:
                raise YAMLError(f"expected a mapping key {self.where()}")
            key, rest = split
            try:
                hash(key)
            except TypeError:
                raise YAMLError(f"unhashable key {self.where()}") from None
            if not rest or rest.startswith("#"):
                self.i += 1
                if (self.content() and _indent_of(self.lines[self.i]) == ind
                        and re.match(r"-( |\t|$)", self.lines[self.i][ind:])):
                    out[key] = self.sequence(ind)
                else:
                    out[key] = self.node(ind)
            else:
                out[key] = self.value(rest, ind, ind, key_line=True)
        return out

    def value(self, text: str, ind: int, parent: int, key_line: bool) -> Any:
        """A scalar or flow node starting with ``text`` on line ``self.i``
        (after a key's ``:`` or as a node of its own), possibly continued on
        lines indented past ``parent``; consumes its lines."""
        ch = text[0]
        if ch in "&*!":
            raise YAMLError(f"anchors, aliases and tags are not supported {self.where()}")
        if ch in "|>":
            return self.block_scalar(text, parent)
        if ch in "'\"[{":
            # Gather lines until the quote or the brackets close.
            start = self.i
            joined = text
            while True:
                try:
                    if ch in "'\"":
                        value, j = _scan_quoted(joined, 0, self.where(start))
                    else:
                        flow = _Flow(joined, self.where(start))
                        value = flow.node()
                        j = flow.i
                    break
                except (YAMLError, IndexError):
                    self.i += 1
                    if self.i >= len(self.lines):
                        raise YAMLError(f"unterminated flow node {self.where(start)}") from None
                    nxt = self.lines[self.i]
                    joined += "\n" + (nxt if ch in "'\"" else _strip_comment(nxt))
            tail = joined[j:].strip(" \t")
            if tail and not tail.startswith("#"):
                raise YAMLError(f"unexpected text after a node: {tail!r} {self.where()}")
            self.i += 1
            return value
        # A plain scalar, folded over its continuation lines.
        first = text[:_plain_end(text)].rstrip(" \t")
        if re.search(r":([ \t]|$)", first):
            raise YAMLError(f"mapping values are not allowed here {self.where()}")
        parts = [first]
        self.i += 1
        breaks = 0
        while self.i < len(self.lines):
            line = self.lines[self.i]
            s = line.strip(" \t")
            if not s:
                breaks += 1
                self.i += 1
                continue
            if _indent_of(line) <= parent or s.startswith("#"):
                break
            cont = s[:_plain_end(s)].rstrip(" \t")
            if not cont:
                break
            parts.append("\n" * breaks if breaks else " ")
            parts.append(cont)
            breaks = 0
            self.i += 1
            if _plain_end(s) < len(s):
                break
        return _plain_value("".join(parts))

    def block_scalar(self, header: str, parent: int) -> str:
        folded = header[0] == ">"
        spec = _strip_comment(header[1:]).strip(" \t")
        chomp = None
        increment = None
        for c in spec:
            if c in "+-" and chomp is None:
                chomp = c == "+"
            elif c.isdigit() and c != "0" and increment is None:
                increment = int(c)
            else:
                raise YAMLError(f"bad block scalar header {header!r} {self.where()}")
        self.i += 1
        start = self.i
        indent = None
        if increment is not None:
            indent = max(parent, 0) + increment if parent >= 0 else increment
        else:
            # The first non-blank line sets the indentation.
            k = start
            while k < len(self.lines) and not self.lines[k].strip(" \t"):
                k += 1
            if k < len(self.lines) and _indent_of(self.lines[k]) > parent:
                indent = _indent_of(self.lines[k])
            else:
                indent = parent + 1 if parent >= 0 else 1
        rows: list[str | None] = []
        while self.i < len(self.lines):
            line = self.lines[self.i]
            if not line.strip(" \t") and len(line) <= indent:
                rows.append(None)
            elif _indent_of(line) >= indent:
                rows.append(line[indent:])
            else:
                break
            self.i += 1
        # Trailing blank lines belong to the scalar only as breaks.
        chunks: list[str] = []
        line_break = ""
        k = 0
        breaks: list[str] = []
        while k < len(rows) and rows[k] is None:
            breaks.append("\n")
            k += 1
        while k < len(rows):
            row = rows[k]
            chunks.extend(breaks)
            leading_non_space = row[:1] not in (" ", "\t")
            chunks.append(row)
            line_break = "\n"
            k += 1
            breaks = []
            while k < len(rows) and rows[k] is None:
                breaks.append("\n")
                k += 1
            if k < len(rows):
                if (folded and line_break == "\n" and leading_non_space
                        and rows[k][:1] not in (" ", "\t")):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
        if chomp is not False:
            chunks.append(line_break)
        if chomp is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def document(self) -> Any:
        value = self.node(-1)
        if self.content():
            raise YAMLError(f"unexpected content {self.where()}")
        return value


def _documents(text: str) -> Iterator[tuple[list[str], int]]:
    """(lines, first line number) per document of a stream."""
    lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
    if lines[-1] == "":
        lines.pop()  # the text after the last line break is no line
    if lines and lines[0].startswith("\uFEFF"):
        lines[0] = lines[0][1:]
    current: list[str] = []
    start = 0
    explicit = False

    def has_content(rows: list[str]) -> bool:
        return any(r.strip(" \t") and not r.strip(" \t").startswith("#") for r in rows)

    for n, line in enumerate(lines):
        if line.startswith("%"):
            raise YAMLError(f"directives are not supported (line {n + 1})")
        if line == "---" or line.startswith("--- ") or line.startswith("---\t"):
            if explicit or has_content(current):
                yield current, start
            rest = line[3:]
            current = [" " * 4 + rest.strip(" \t")] if rest.strip(" \t") and not rest.strip(" \t").startswith("#") else []
            start = n if current else n + 1
            explicit = True
            continue
        if line == "..." or line.startswith("... "):
            if explicit or has_content(current):
                yield current, start
            current, start, explicit = [], n + 1, False
            continue
        current.append(line)
    if explicit or has_content(current):
        yield current, start


def safe_load_all(stream: Any) -> Iterator[Any]:
    """``yaml.safe_load_all(stream)``: a string, bytes or a text file."""
    if hasattr(stream, "read"):
        stream = stream.read()
    if isinstance(stream, bytes):
        stream = stream.decode("utf-8")
    for lines, first in _documents(stream):
        yield _Block(lines, first).document()


def safe_load(stream: Any) -> Any:
    """``yaml.safe_load(stream)``: the stream's one document, None when it
    has none; more than one raises ``YAMLError``."""
    docs = list(safe_load_all(stream))
    if len(docs) > 1:
        raise YAMLError("expected a single document in the stream")
    return docs[0] if docs else None
