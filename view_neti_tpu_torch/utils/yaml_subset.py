"""A reader and a writer for the subset of YAML that run configs use.

The machine with the card has no PyYAML, so the port reads and writes its
configs itself. The reader covers what input_configs/*.yaml use: nested
block maps and block lists, inline `{}` maps and `[]` lists, single- and
double-quoted strings, comments, and plain scalars resolved by the YAML 1.1
rules that `yaml.safe_load` applies (so `1e-3` stays a string, bare `no` is
False, `0o`-less `010` is octal). Anchors, tags, multi-line strings and
multiple documents are not supported and raise.

The writer emits block maps and inline lists whose every string is
double-quoted, so `yaml.safe_load` reads back exactly the tree it was given.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


class YAMLSubsetError(ValueError):
    pass


def _sexagesimal(text: str, conv) -> Any:
    sign = -1 if text.startswith("-") else 1
    digits = [conv(p) for p in text.lstrip("+-").split(":")]
    value, base = 0, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return sign * value


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar as yaml.safe_load resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if ":" in body:
            return _sexagesimal(t, int)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith(".nan"):
            return math.nan
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"timestamps are not supported: {text!r}")
    if text.startswith(("&", "*", "!", "|", ">", "%", "@", "`")):
        raise YAMLSubsetError(f"unsupported YAML construct: {text!r}")
    return text


# ---------------------------------------------------------------- reader --

def _strip_comment(line: str) -> str:
    """Drop a comment: '#' at the start or after whitespace, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    continue
                if quote == '"' and line[i - 1] == "\\":
                    continue
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at text[i]; returns (value, index after
    the closing quote)."""
    q = text[i]
    j = i + 1
    out = []
    while j < len(text):
        ch = text[j]
        if q == "'":
            if ch == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
            j += 1
        else:
            if ch == "\\":
                k = j + 2
                esc = text[j + 1:k]
                if esc in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[esc]
                    out.append(chr(int(text[k:k + n], 16)))
                    j = k + n
                    continue
                table = {"n": "\n", "t": "\t", "r": "\r", "0": "\0",
                         '"': '"', "\\": "\\", "/": "/", " ": " ",
                         "a": "\a", "b": "\b", "e": "\x1b", "f": "\f",
                         "v": "\v", "N": "\x85", "_": "\xa0"}
                if esc not in table:
                    raise YAMLSubsetError(f"bad escape \\{esc} in {text!r}")
                out.append(table[esc])
                j = k
                continue
            if ch == '"':
                return "".join(out), j + 1
            out.append(ch)
            j += 1
    raise YAMLSubsetError(f"unterminated string in {text!r}")


class _Flow:
    """Parser of one inline collection or scalar."""

    def __init__(self, text: str):
        self.t = text
        self.i = 0

    def ws(self):
        while self.i < len(self.t) and self.t[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        self.ws()
        if self.i >= len(self.t):
            return None
        ch = self.t[self.i]
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        if ch in "'\"":
            s, self.i = _quoted(self.t, self.i)
            return s
        return resolve_plain(self.plain(in_flow, key=False))

    def plain(self, in_flow: bool, key: bool) -> str:
        start = self.i
        while self.i < len(self.t):
            ch = self.t[self.i]
            if in_flow and ch in ",]}":
                break
            if ch == ":" and (self.i + 1 == len(self.t)
                              or self.t[self.i + 1] in " \t,]}"):
                if key or in_flow:
                    break
            self.i += 1
        return self.t[start:self.i].strip()

    def expect(self, ch: str):
        self.ws()
        if self.i >= len(self.t) or self.t[self.i] != ch:
            raise YAMLSubsetError(f"expected {ch!r} at {self.i} in "
                                  f"{self.t!r}")
        self.i += 1

    def seq(self) -> List[Any]:
        self.expect("[")
        out = []
        while True:
            self.ws()
            if self.t[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(in_flow=True))
            self.ws()
            if self.t[self.i:self.i + 1] == ",":
                self.i += 1

    def map(self) -> dict:
        self.expect("{")
        out = {}
        while True:
            self.ws()
            if self.t[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            if self.t[self.i] in "'\"":
                key, self.i = _quoted(self.t, self.i)
            else:
                key = resolve_plain(self.plain(in_flow=True, key=True))
            self.ws()
            value = None
            if self.t[self.i:self.i + 1] == ":":
                self.i += 1
                self.ws()
                if self.t[self.i:self.i + 1] not in (",", "}"):
                    value = self.value(in_flow=True)
            out[key] = value
            self.ws()
            if self.t[self.i:self.i + 1] == ",":
                self.i += 1


def _inline(text: str) -> Any:
    p = _Flow(text)
    value = p.value(in_flow=False)
    p.ws()
    if p.i != len(text):
        raise YAMLSubsetError(f"trailing text in {text!r}")
    return value


def _split_key(content: str) -> Tuple[Any, str]:
    """`key: rest` -> (resolved key, rest); raises if there is no key."""
    if content[0] in "'\"":
        key, i = _quoted(content, 0)
    else:
        p = _Flow(content)
        raw = p.plain(in_flow=False, key=True)
        key, i = resolve_plain(raw), p.i
    rest = content[i:].lstrip(" \t")
    if not rest.startswith(":"):
        raise YAMLSubsetError(f"expected 'key: value', got {content!r}")
    return key, rest[1:].strip()


def _balanced(text: str) -> bool:
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth <= 0


class _Block:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLSubsetError("tabs in indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if line.strip() in ("---", "..."):
                if self.lines:
                    raise YAMLSubsetError("multiple documents")
                continue
            self.lines.append((len(line) - len(line.lstrip(" ")),
                               line.strip()))
        self.k = 0

    def _join_flow(self, rest: str) -> str:
        while not _balanced(rest) and self.k < len(self.lines):
            rest += " " + self.lines[self.k][1]
            self.k += 1
        return rest

    def node(self, indent: int) -> Any:
        _, content = self.lines[self.k]
        if content == "-" or content.startswith("- "):
            return self.seq(indent)
        if content[0] in "[{" or ":" not in content:
            self.k += 1
            return _inline(self._join_flow(content))
        return self.map(indent)

    def _value_after(self, rest: str, indent: int, in_seq_item=False):
        """The value of a `key:` or `-` whose inline text is `rest`."""
        if rest:
            return _inline(self._join_flow(rest))
        if self.k < len(self.lines):
            nxt_indent, nxt = self.lines[self.k]
            if nxt_indent > indent:
                return self.node(nxt_indent)
            if (nxt_indent == indent and not in_seq_item
                    and (nxt == "-" or nxt.startswith("- "))):
                return self.seq(indent)
        return None

    def map(self, indent: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            ind, content = self.lines[self.k]
            if ind < indent:
                break
            if ind > indent or content == "-" or content.startswith("- "):
                raise YAMLSubsetError(f"bad indentation at {content!r}")
            key, rest = _split_key(content)
            self.k += 1
            if key in out:
                raise YAMLSubsetError(f"duplicate key {key!r}")
            out[key] = self._value_after(rest, indent)
        return out

    def seq(self, indent: int) -> list:
        out = []
        while self.k < len(self.lines):
            ind, content = self.lines[self.k]
            if ind != indent or not (content == "-"
                                     or content.startswith("- ")):
                if ind > indent:
                    raise YAMLSubsetError(f"bad indentation at {content!r}")
                break
            item = content[1:].lstrip(" ")
            if not item:
                self.k += 1
                out.append(self._value_after("", indent, in_seq_item=True))
                continue
            # "- key: value" opens a map whose keys sit at the item's column
            sub = indent + (len(content) - len(item))
            if item[0] not in "[{'\"" and re.search(r":(\s|$)", item):
                self.lines[self.k] = (sub, item)
                out.append(self.map(sub))
            else:
                self.k += 1
                out.append(_inline(self._join_flow(item)))
        return out


def loads(text: str) -> Any:
    """Parse a YAML document of the supported subset."""
    block = _Block(text)
    if not block.lines:
        return None
    value = block.node(block.lines[0][0])
    if block.k != len(block.lines):
        raise YAMLSubsetError(
            f"unparsed text from {block.lines[block.k][1]!r}")
    return value


# ---------------------------------------------------------------- writer --

def _scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 reads a float only with a dot: 1e-08 -> 1.0e-08
        if "." not in text:
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def _dump(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for k, x in v.items():
        if isinstance(x, dict) and x:
            out.append(f"{pad}{_scalar(k)}:")
            _dump(x, indent + 2, out)
        else:
            out.append(f"{pad}{_scalar(k)}: {_flow(x)}")


def dumps(tree: dict) -> str:
    """A YAML document that yaml.safe_load reads back as `tree` (a dict of
    str keys whose leaves are None, bool, int, float, str, lists and
    dicts)."""
    out: List[str] = []
    _dump(tree, 0, out)
    return "\n".join(out) + "\n"
