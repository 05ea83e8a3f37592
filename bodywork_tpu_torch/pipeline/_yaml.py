"""The YAML the pipeline spec and the k8s manifests need, without pyyaml.

The port runs on the standard library, numpy and torch alone, with no
pyyaml, yet the deployment half writes the spec YAML, the manifests and
their ConfigMap, and every pod reads the spec back. This module covers
exactly that subset:

- :func:`dump` writes a mapping of block mappings (insertion order) and
  block sequences, with ``str``, ``int``, ``float``, ``bool`` and ``None``
  scalars, byte for byte as ``yaml.safe_dump(doc, sort_keys=False)``
  does: its plain, single- and double-quoted choices, the quoting of a
  string that would read back as another type (``'true'``, ``''``,
  ``'1'``), the folding of long scalars at width 80, ``{}`` and ``[]``
  for empty collections, and ``&id001`` / ``*id001`` where one dict or
  list object appears twice;
- :func:`load` reads what :func:`dump` writes (and single-line flow
  sequences of scalars) back to the values ``yaml.safe_load`` gives.

Anything else (other types, non-ASCII or control characters, tags,
block scalars, comments, timestamps, complex keys) raises
``ValueError`` naming the value or the line: neither function guesses.
"""
from __future__ import annotations

import math
import re

__all__ = ["dump", "load"]

_WIDTH = 80
_INDENT = 2
_BREAKS = "\n"

# YAML 1.1's implicit types, as pyyaml's resolver matches a plain scalar
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT_RE = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_MERGE_RE = re.compile(r"^(?:<<)$")
_NULL_RE = re.compile(r"^(?: ~ |null|Null|NULL | )$", re.X)
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE_RE = re.compile(r"^(?:=)$")

#: (type, regex, the first characters the resolver tries it for)
_RESOLVERS = (
    ("bool", _BOOL_RE, "yYnNtTfFoO"),
    ("float", _FLOAT_RE, "-+0123456789."),
    ("int", _INT_RE, "-+0123456789"),
    ("merge", _MERGE_RE, "<"),
    ("null", _NULL_RE, "~nN"),
    ("timestamp", _TIMESTAMP_RE, "0123456789"),
    ("value", _VALUE_RE, "="),
)


def _resolve(value: str) -> str:
    """The type a plain scalar ``value`` reads back as ("str" when none
    of YAML 1.1's implicit types matches)."""
    if value == "":
        return "null"
    for kind, regex, first in _RESOLVERS:
        if value[0] in first and regex.match(value):
            return kind
    return "str"


# --------------------------------------------------------------------------
# dump
# --------------------------------------------------------------------------


class _Analysis:
    __slots__ = ("empty", "multiline", "allow_block_plain", "allow_single_quoted")

    def __init__(self, scalar: str):
        self.empty = not scalar
        self.multiline = False
        self.allow_block_plain = True
        self.allow_single_quoted = True
        if not scalar:
            return
        block_indicators = scalar.startswith(("---", "..."))
        line_breaks = leading = trailing = break_space = space_break = False
        preceded_by_ws = True
        followed_by_ws = len(scalar) == 1 or scalar[1] in "\0 \t\r\n"
        previous_space = previous_break = False
        for index, ch in enumerate(scalar):
            if index == 0:
                if ch in "#,[]{}&*!|>'\"%@`":
                    block_indicators = True
                if ch in "?:" and followed_by_ws:
                    block_indicators = True
                if ch == "-" and followed_by_ws:
                    block_indicators = True
            else:
                if ch == ":" and followed_by_ws:
                    block_indicators = True
                if ch == "#" and preceded_by_ws:
                    block_indicators = True
            if ch in _BREAKS:
                line_breaks = True
            if ch == " ":
                leading = leading or index == 0
                trailing = trailing or index == len(scalar) - 1
                break_space = break_space or previous_break
                previous_space, previous_break = True, False
            elif ch in _BREAKS:
                leading = leading or index == 0
                trailing = trailing or index == len(scalar) - 1
                space_break = space_break or previous_space
                previous_space, previous_break = False, True
            else:
                previous_space = previous_break = False
            preceded_by_ws = ch in "\0 \t\r\n"
            followed_by_ws = (index + 2 >= len(scalar)
                              or scalar[index + 2] in "\0 \t\r\n")
        self.multiline = line_breaks
        if leading or trailing or line_breaks or block_indicators:
            self.allow_block_plain = False
        if break_space or space_break:
            self.allow_single_quoted = False


class _Emitter:
    """pyyaml's emitter state for one block-style document: the column,
    the indentation stack and the whitespace / indention flags that
    decide where a space or a line break goes."""

    def __init__(self, anchors: dict):
        self.out: list[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent: int | None = None
        self.indents: list = []
        self.anchors = anchors          # id(obj) -> anchor name
        self.emitted: set = set()       # ids already written once

    # -- writers (pyyaml's, for the styles the subset uses) ---------------
    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text: str, need_whitespace: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        data = text if self.whitespace or not need_whitespace else " " + text
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.write(data)

    def line_break(self) -> None:
        self.whitespace = True
        self.indention = True
        self.out.append("\n")
        self.column = 0

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.out.append(" " * (indent - self.column))
            self.column = indent

    def push_indent(self, flow: bool = False, indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = _INDENT if flow else 0
        elif not indentless:
            self.indent += _INDENT

    def pop_indent(self) -> None:
        self.indent = self.indents.pop()

    def plain(self, text: str, split: bool) -> None:
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    if text[start] == "\n":
                        self.line_break()
                    for _br in text[start:end]:
                        self.line_break()
                    self.write_indent()
                    start = end
            elif ch is None or ch in " \n" or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self.indicator("'", False)

    _ESCAPES = {"\n": "n", '"': '"', "\\": "\\"}

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\n':
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    self.write("\\" + self._ESCAPES[ch])
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _WIDTH and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)

    # -- nodes ------------------------------------------------------------
    def scalar(self, value: str, is_str: bool, simple_key: bool) -> None:
        analysis = _Analysis(value)
        plain_ok = (not is_str) or _resolve(value) == "str"
        if (plain_ok and not (simple_key and (analysis.empty or analysis.multiline))
                and analysis.allow_block_plain):
            style = ""
        elif analysis.allow_single_quoted and not (simple_key and analysis.multiline):
            style = "'"
        else:
            style = '"'
        self.push_indent(flow=True)
        split = not simple_key
        if style == "":
            self.plain(value, split)
        elif style == "'":
            self.single_quoted(value, split)
        else:
            self.double_quoted(value, split)
        self.pop_indent()

    def node(self, obj, mapping: bool = False, simple_key: bool = False) -> None:
        if isinstance(obj, (dict, list)):
            anchor = self.anchors.get(id(obj))
            if anchor is not None and id(obj) in self.emitted:
                self.indicator("*" + anchor, True)
                return
            self.emitted.add(id(obj))
            if anchor is not None:
                self.indicator("&" + anchor, True)
            if isinstance(obj, dict):
                self.block_mapping(obj)
            else:
                self.block_sequence(obj, mapping)
            return
        self.scalar(*_represent(obj), simple_key=simple_key)

    def block_sequence(self, items: list, mapping: bool) -> None:
        if not items:
            self.indicator("[", True, whitespace=True)
            self.indicator("]", False)
            return
        self.push_indent(flow=False, indentless=mapping and not self.indention)
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.pop_indent()

    def block_mapping(self, doc: dict) -> None:
        if not doc:
            self.indicator("{", True, whitespace=True)
            self.indicator("}", False)
            return
        self.push_indent(flow=False)
        for key, value in doc.items():
            if type(key) is not str:
                raise ValueError(f"YAML subset: mapping keys are str, got {key!r}")
            if not key or len(key) >= 128 or any(c in _BREAKS for c in key):
                raise ValueError(f"YAML subset: {key!r} cannot be a simple key")
            self.write_indent()
            self.node(key, mapping=True, simple_key=True)
            self.indicator(":", False)
            self.node(value, mapping=True)
        self.pop_indent()


def _check_str(value: str) -> None:
    for ch in value:
        if not (ch == "\n" or " " <= ch <= "~"):
            raise ValueError(f"YAML subset: {value!r} holds {ch!r} (printable ASCII "
                             "and line breaks only)")


def _represent(obj) -> tuple[str, bool]:
    """``(text, is_str)`` of a scalar, as pyyaml's safe representer
    writes it."""
    kind = type(obj)
    if obj is None:
        return "null", False
    if kind is bool:
        return ("true" if obj else "false"), False
    if kind is int:
        return str(obj), False
    if kind is float:
        if math.isnan(obj):
            return ".nan", False
        if math.isinf(obj):
            return (".inf" if obj > 0 else "-.inf"), False
        text = repr(obj).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, False
    if kind is str:
        _check_str(obj)
        return obj, True
    raise ValueError(f"YAML subset: cannot represent {obj!r} ({kind.__name__})")


def _assign_anchors(doc) -> dict:
    """id -> ``idNNN`` for every dict or list reached twice, numbered in
    the order pyyaml's serializer meets the second reference."""
    seen: set = set()
    anchors: dict = {}

    def visit(obj) -> None:
        if not isinstance(obj, (dict, list)):
            return
        if id(obj) in seen:
            if id(obj) not in anchors:
                anchors[id(obj)] = f"id{len(anchors) + 1:03d}"
            return
        seen.add(id(obj))
        for item in (obj.items() if isinstance(obj, dict) else obj):
            if isinstance(item, tuple):
                visit(item[0])
                visit(item[1])
            else:
                visit(item)

    visit(doc)
    return anchors


def dump(doc: dict) -> str:
    """``doc`` as ``yaml.safe_dump(doc, sort_keys=False)`` writes it; a
    value outside the subset raises ``ValueError``."""
    if type(doc) is not dict:
        raise ValueError(f"YAML subset: a document is a dict, got {type(doc).__name__}")
    emitter = _Emitter(_assign_anchors(doc))
    emitter.node(doc)
    emitter.write_indent()
    return "".join(emitter.out)


# --------------------------------------------------------------------------
# load
# --------------------------------------------------------------------------

#: the escapes a double-quoted scalar of the subset holds (what the writer
#: emits: a line break, a quote, a backslash, and a space kept at the
#: start of a folded line)
_UNESCAPES = {"n": "\n", '"': '"', "\\": "\\", " ": " "}


def _construct(value: str, where: str):
    """A plain scalar's value, as pyyaml's safe constructor builds it."""
    kind = _resolve(value)
    if kind == "str":
        return value
    if kind == "null":
        return None
    if kind == "bool":
        return value.lower() in ("yes", "true", "on")
    if kind == "int":
        digits = value.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        body = digits.lstrip("+-")
        if body == "0":
            return 0
        if body.startswith(("0b", "0x")) or body[0] == "0" or ":" in body:
            raise ValueError(f"YAML subset: {where}: {value!r} is an integer form the "
                             "subset does not read (decimal only)")
        return sign * int(body)
    if kind == "float":
        text = value.replace("_", "").lower()
        sign = -1.0 if text[0] == "-" else 1.0
        body = text.lstrip("+-")
        if body == ".inf":
            return sign * math.inf
        if body == ".nan":
            return math.nan
        if ":" in body:
            raise ValueError(f"YAML subset: {where}: sexagesimal {value!r} is outside "
                             "the subset")
        return sign * float(body)
    raise ValueError(f"YAML subset: {where}: {value!r} reads as a YAML {kind}, "
                     "which the subset does not construct")


class _Parser:
    def __init__(self, text: str):
        if "\t" in text or "\r" in text:
            raise ValueError("YAML subset: tabs and carriage returns are outside the subset")
        self.text = text if text.endswith("\n") else text + "\n"
        self.pos = 0
        self.anchors: dict = {}

    # -- positions --------------------------------------------------------
    def where(self, pos: int | None = None) -> str:
        pos = self.pos if pos is None else pos
        return f"line {self.text.count(chr(10), 0, pos) + 1}"

    def fail(self, what: str, pos: int | None = None):
        raise ValueError(f"YAML subset: {self.where(pos)}: {what}")

    def column(self, pos: int | None = None) -> int:
        pos = self.pos if pos is None else pos
        return pos - (self.text.rfind("\n", 0, pos) + 1)

    def peek(self, offset: int = 0) -> str:
        i = self.pos + offset
        return self.text[i] if i < len(self.text) else "\0"

    def at_eof(self) -> bool:
        return self.pos >= len(self.text)

    def line_indent(self, pos: int) -> tuple[int, int]:
        """``(indent, content position)`` of the line starting at ``pos``."""
        end = pos
        while end < len(self.text) and self.text[end] == " ":
            end += 1
        return end - pos, end

    def next_line(self) -> int | None:
        """Start of the next line holding content (the cursor must sit on
        a line break); a blank or comment line is refused."""
        if self.peek() != "\n":
            self.fail(f"unexpected {self.text[self.pos:].splitlines()[0]!r}")
        start = self.pos + 1
        if start >= len(self.text):
            return None
        indent, content = self.line_indent(start)
        if self.text[content] == "\n":
            self.fail("blank lines outside a quoted scalar are outside the subset", start)
        if self.text[content] == "#":
            self.fail("comments are outside the subset", start)
        return start

    # -- document ---------------------------------------------------------
    def document(self):
        indent, content = self.line_indent(0)
        if indent:
            self.fail("a document starts at column 0", 0)
        self.pos = content
        if self.text.startswith(("---", "...", "%"), content):
            self.fail("document markers and directives are outside the subset")
        if self.text.startswith("{}", content):
            self.pos += 2
            value: dict = {}
        elif self.is_sequence_entry(content):
            value = self.block_sequence(0)
        else:
            value = self.block_mapping(0)
        if self.peek() != "\n" or self.pos + 1 != len(self.text):
            self.fail("content after the document's root node")
        return value

    def is_sequence_entry(self, pos: int) -> bool:
        return self.text[pos] == "-" and self.text[pos + 1] in " \n"

    # -- block collections -------------------------------------------------
    def block_mapping(self, indent: int) -> dict:
        """A block mapping whose first key sits at the cursor (column
        ``indent``); later keys start lines at that indent."""
        result: dict = {}
        while True:
            key_pos = self.pos
            key = self.key()
            if key in result:
                self.fail(f"duplicate key {key!r}", key_pos)
            result[key] = self.value_after_colon(indent)
            start = self.next_line()
            if start is None:
                return result
            line_indent, content = self.line_indent(start)
            if line_indent < indent or (line_indent == indent and self.is_sequence_entry(content)):
                self.pos = start - 1
                return result
            if line_indent > indent:
                self.fail("unexpected indentation", content)
            self.pos = content

    def block_sequence(self, indent: int) -> list:
        """A block sequence whose first ``-`` sits at the cursor (column
        ``indent``)."""
        result = []
        while True:
            if not self.is_sequence_entry(self.pos):
                self.fail("expected a '-' entry")
            self.pos += 1
            if self.peek() == "\n":
                self.fail("an empty sequence entry is outside the subset")
            self.pos += 1
            result.append(self.sequence_item(indent))
            start = self.next_line()
            if start is None:
                return result
            line_indent, content = self.line_indent(start)
            if line_indent < indent or (line_indent == indent
                                        and not self.is_sequence_entry(content)):
                self.pos = start - 1
                return result
            if line_indent > indent:
                self.fail("unexpected indentation", content)
            self.pos = content

    def sequence_item(self, indent: int):
        col = self.column()
        ch = self.peek()
        if ch == "-" and self.peek(1) in " \n":
            return self.block_sequence(col)
        if ch in "&*[{":
            return self.node_inline(indent, indentless_ok=False)
        # a compact mapping ("- key: value") or a scalar entry
        save = self.pos
        try:
            self.key()
            is_mapping = True
        except ValueError:
            is_mapping = False
        self.pos = save
        if is_mapping:
            return self.block_mapping(col)
        return self.scalar(indent)

    def value_after_colon(self, indent: int):
        if self.peek() == "\n":
            return self.nested(indent, indentless_ok=True)
        if self.peek() != " ":
            self.fail("expected a space after ':'")
        self.pos += 1
        return self.node_inline(indent, indentless_ok=True)

    def nested(self, indent: int, indentless_ok: bool):
        """The collection on the lines after the cursor's line break."""
        start = self.next_line()
        if start is None:
            self.fail("a key or entry without a value is outside the subset")
        line_indent, content = self.line_indent(start)
        if indentless_ok and line_indent == indent and self.is_sequence_entry(content):
            self.pos = content
            return self.block_sequence(indent)
        if line_indent <= indent:
            self.fail("a key or entry without a value is outside the subset", start)
        self.pos = content
        if self.is_sequence_entry(content):
            return self.block_sequence(line_indent)
        return self.block_mapping(line_indent)

    def node_inline(self, indent: int, indentless_ok: bool):
        ch = self.peek()
        if ch == "&":
            name = self.anchor_name()
            if self.peek() == "\n":
                value = self.nested(indent, indentless_ok)
            elif self.peek() == " " and self.peek(1) in "[{":
                self.pos += 1
                value = self.flow()
            else:
                self.fail("an anchor on a scalar is outside the subset")
            self.anchors[name] = value
            return value
        if ch == "*":
            name = self.anchor_name()
            if name not in self.anchors:
                self.fail(f"alias *{name} before its anchor")
            return self.anchors[name]
        if ch in "[{":
            return self.flow()
        return self.scalar(indent)

    def anchor_name(self) -> str:
        start = self.pos + 1
        end = start
        while end < len(self.text) and (self.text[end].isalnum() or self.text[end] in "-_"):
            end += 1
        if end == start:
            self.fail("an empty anchor name")
        self.pos = end
        return self.text[start:end]

    def flow(self):
        """``{}``, ``[]``, or a one-line flow sequence of scalars."""
        if self.text.startswith("{}", self.pos):
            self.pos += 2
            return {}
        if self.peek() == "{":
            self.fail("a non-empty flow mapping is outside the subset")
        self.pos += 1
        items = []
        while True:
            while self.peek() == " ":
                self.pos += 1
            if self.peek() == "]" and not items:
                self.pos += 1
                return items
            ch = self.peek()
            if ch in "'\"":
                items.append(self.quoted())
            elif ch in "[]{},&*!|>%@`#?:\n":
                self.fail(f"{ch!r} in a flow sequence is outside the subset")
            else:
                start = self.pos
                while self.peek() not in ",]\n":
                    self.pos += 1
                items.append(_construct(self.text[start:self.pos].rstrip(" "), self.where()))
            while self.peek() == " ":
                self.pos += 1
            if self.peek() == ",":
                self.pos += 1
                continue
            if self.peek() == "]":
                self.pos += 1
                return items
            self.fail("an unterminated flow sequence")

    # -- scalars ----------------------------------------------------------
    def key(self) -> str:
        """A simple key at the cursor, which ends on its ``:``."""
        ch = self.peek()
        if ch in "'\"":
            value = self.quoted(single_line=True)
        else:
            if ch in "#,[]{}&*!|>%@`?-" and not (ch in "?-" and self.peek(1) not in " \n"):
                self.fail(f"{ch!r} cannot start a plain key")
            line_end = self.text.index("\n", self.pos)
            candidates = [i for i in (self.text.find(": ", self.pos, line_end),
                                      line_end - 1 if self.text[line_end - 1] == ":" else -1)
                          if i >= 0]
            if not candidates:
                self.fail("expected 'key:'")
            end = min(candidates)
            raw = self.text[self.pos:end]
            if not raw or raw != raw.strip(" ") or " #" in raw:
                self.fail(f"malformed key {raw!r}")
            value = _construct(raw, self.where())
            if not isinstance(value, str):
                self.fail(f"a {type(value).__name__} key {raw!r} is outside the subset")
            self.pos = end
        if self.peek() != ":" or self.peek(1) not in " \n":
            self.fail("expected ':' after the key")
        self.pos += 1
        return value

    def scalar(self, indent: int):
        ch = self.peek()
        if ch in "'\"":
            return self.quoted()
        if ch in "#,[]{}&*!|>%@`":
            self.fail(f"{ch!r} cannot start a plain scalar")
        if ch in "?:-" and self.peek(1) in " \n":
            self.fail(f"{ch!r} followed by a space cannot start a plain scalar")
        start_pos = self.pos
        line_end = self.text.index("\n", self.pos)
        words = [self.text[self.pos:line_end]]
        self.pos = line_end
        # folded continuation lines: more indented than the parent node
        while self.pos + 1 < len(self.text):
            line_indent, content = self.line_indent(self.pos + 1)
            if line_indent <= indent or self.text[content] == "\n":
                break
            end = self.text.index("\n", content)
            words.append(self.text[content:end])
            self.pos = end
        for word in words:
            if word != word.rstrip(" ") or ": " in word or word.endswith(":") or " #" in word:
                self.fail(f"malformed plain scalar {word!r}", start_pos)
        return _construct(" ".join(words), self.where(start_pos))

    def quoted(self, single_line: bool = False) -> str:
        """A single- or double-quoted scalar, folded as YAML folds flow
        scalars: a lone line break reads as a space, each further one as
        a line break; a double-quoted ``\\`` at a line's end joins it to
        the next."""
        quote = self.peek()
        start_pos = self.pos
        self.pos += 1
        chunks: list[str] = []
        text = self.text
        while True:
            if self.pos >= len(text):
                self.fail("an unterminated quoted scalar", start_pos)
            ch = text[self.pos]
            if ch == quote:
                if quote == "'" and self.peek(1) == "'":
                    chunks.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                break
            if quote == '"' and ch == "\\":
                esc = self.peek(1)
                if esc in _UNESCAPES:
                    chunks.append(_UNESCAPES[esc])
                    self.pos += 2
                elif esc == "\n":
                    self.pos += 2
                    chunks.extend(self.breaks())
                else:
                    self.fail(f"the escape \\{esc} is outside the subset")
                continue
            if ch in " \n":
                end = self.pos
                while text[end] == " ":
                    end += 1
                if text[end] == "\n":
                    if single_line:
                        self.fail("a key spanning lines is outside the subset", start_pos)
                    self.pos = end + 1
                    breaks = self.breaks()
                    chunks.append("".join(breaks) if breaks else " ")
                else:
                    chunks.append(text[self.pos:end])
                    self.pos = end
                continue
            chunks.append(ch)
            self.pos += 1
        return "".join(chunks)

    def breaks(self) -> list[str]:
        """The line breaks of the empty lines after a folded break, the
        cursor left on the next line's first non-space."""
        out = []
        while True:
            while self.peek() == " ":
                self.pos += 1
            if self.peek() == "\n":
                out.append("\n")
                self.pos += 1
                continue
            return out


def load(text: str):
    """The document ``text`` (a block mapping, or ``{}``), with the values
    ``yaml.safe_load`` gives; anything outside the subset raises
    ``ValueError`` naming its line."""
    return _Parser(text).document()
