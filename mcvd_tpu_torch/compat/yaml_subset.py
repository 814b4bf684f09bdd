"""A reader and a writer for the subset of YAML this repository uses, so the
port needs no PyYAML (the card machine has none).

The subset: the shipped `configs/*.yml` (block mappings, flow mappings and
flow lists that may span lines, comments, plain and quoted scalars) and what
the port writes (`config.yml`, `args.yml`, `best_metrics.yml`,
`vid_metrics.yml`: block mappings and block lists of scalars). Plain scalars
resolve as PyYAML's `safe_load` resolves them (YAML 1.1): null/~/empty,
true/false/yes/no/on/off in their three cases, decimal, octal, hex and
binary ints, floats only with a dot (`1.0e-08` is a float, `1e-8` a string),
.inf and .nan. Not covered, and refused where met: anchors, aliases, tags,
multi-line plain or block scalars (`|`, `>`), mappings inside block lists,
several documents. `dump` writes what `load` and `yaml.safe_load` read back
as the same value: keys sorted, floats in PyYAML's form (`1.0e-08`), strings
quoted where a plain one would read as something else.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


class YAMLSubsetError(ValueError):
    """The text is outside the subset this module reads."""


def resolve_scalar(s: str) -> Any:
    """A plain (unquoted) scalar as `yaml.safe_load` resolves it."""
    if _NULL.match(s):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t == ".nan":
            return math.nan
        return float(t)
    return s


# ------------------------------------------------------------------ reading

def _strip_comment(line: str) -> str:
    """The line less a comment: '#' at its start or after a space, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i] and the index past it."""
    q = text[i]
    out, j = [], i + 1
    while j < len(text):
        ch = text[j]
        if q == "'" and ch == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            nxt = text[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}.get(nxt, nxt))
            j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise YAMLSubsetError(f"unterminated quoted scalar: {text[i:i + 40]!r}")


class _Flow:
    """A parser of one flow collection or scalar (the text of a value,
    continuation lines joined with spaces)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        self.ws()
        ch = self.s[self.i:self.i + 1]
        if ch == "{":
            return self.mapping()
        if ch == "[":
            return self.sequence()
        if ch in ("'", '"'):
            v, self.i = _quoted(self.s, self.i)
            return v
        if ch in ("&", "*", "!", "|", ">"):
            raise YAMLSubsetError(f"not in the subset: {self.s[self.i:self.i + 40]!r}")
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if in_flow and c in ",]}":
                break
            if c == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", "\t") + (
                    (",", "]", "}") if in_flow else ()):
                break
            self.i += 1
        return resolve_scalar(self.s[start:self.i].strip())

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(True)
            self.ws()
            if self.s[self.i:self.i + 1] != ":":
                raise YAMLSubsetError(f"expected ':' in a flow mapping at "
                                      f"{self.s[self.i:self.i + 40]!r}")
            self.i += 1
            out[key] = self.value(True)
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "}":
                raise YAMLSubsetError(f"expected ',' or '}}' at {self.s[self.i:self.i + 40]!r}")

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self.ws()
            c = self.s[self.i:self.i + 1]
            if c == ",":
                self.i += 1
            elif c != "]":
                raise YAMLSubsetError(f"expected ',' or ']' at {self.s[self.i:self.i + 40]!r}")


def _depth(text: str) -> int:
    """Open flow brackets in `text`, quotes skipped."""
    d, i = 0, 0
    while i < len(text):
        ch = text[i]
        if ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            _, i = _quoted(text, i)
            continue
        d += ch in "[{"
        d -= ch in "]}"
        i += 1
    return d


def _flow_value(text: str, lines: List[Tuple[int, str]], k: int) -> Tuple[Any, int]:
    """The value whose text starts `text` on line k - 1, with the lines that
    continue an open flow collection; the index of the next line."""
    while _depth(text) > 0:
        if k >= len(lines):
            raise YAMLSubsetError(f"unclosed flow collection: {text[:40]!r}")
        text += " " + lines[k][1]
        k += 1
    p = _Flow(text)
    v = p.value(False)
    p.ws()
    if p.i != len(p.s):
        raise YAMLSubsetError(f"trailing text: {p.s[p.i:p.i + 40]!r}")
    return v, k


def _split_key(text: str) -> Tuple[str, str]:
    """(key, rest) of a block mapping line 'key: rest', or raise."""
    if text[0] in "'\"":
        key, j = _quoted(text, 0)
        if text[j:j + 1] != ":":
            raise YAMLSubsetError(f"expected ':' after a quoted key: {text!r}")
        return key, text[j + 1:].strip()
    m = re.match(r"^([^\s#'\"{\[][^:]*?)\s*:(?:\s+|$)(.*)$", text)
    if not m:
        raise YAMLSubsetError(f"not a 'key: value' line: {text!r}")
    return resolve_scalar(m.group(1)), m.group(2).strip()


def _block(lines, k: int, indent: int) -> Tuple[Any, int]:
    """The block node whose first line, lines[k], is at `indent`."""
    if lines[k][1].startswith("- ") or lines[k][1] == "-":
        out = []
        while k < len(lines) and lines[k][0] == indent and (
                lines[k][1].startswith("- ") or lines[k][1] == "-"):
            item = lines[k][1][1:].strip()
            if re.match(r"^[^'\"{\[].*?:(\s|$)", item):
                raise YAMLSubsetError(f"mappings inside block lists are not in the subset: "
                                      f"{item!r}")
            v, k = _flow_value(item, lines, k + 1)
            out.append(v)
        return out, k
    out = {}
    while k < len(lines) and lines[k][0] == indent:
        key, rest = _split_key(lines[k][1])
        k += 1
        if rest:
            out[key], k = _flow_value(rest, lines, k)
        elif k < len(lines) and (lines[k][0] > indent or (
                lines[k][0] == indent and lines[k][1].startswith("- "))):
            out[key], k = _block(lines, k, lines[k][0])
        else:
            out[key] = None
    if k < len(lines) and lines[k][0] > indent:
        raise YAMLSubsetError(f"unexpected indentation: {lines[k][1]!r}")
    return out, k


def load(text: str) -> Any:
    """The document in `text`, as `yaml.safe_load(text)` gives it for the
    subset; raises `YAMLSubsetError` outside it."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            if lines:
                raise YAMLSubsetError("several documents are not in the subset")
            continue
        line = _strip_comment(raw).rstrip()
        if line.strip():
            if "\t" in line[:len(line) - len(line.lstrip())]:
                raise YAMLSubsetError("tabs in indentation")
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    first = lines[0][1]
    if first[0] in "{['\"" or not re.search(r":(\s|$)", first) and not first.startswith("-"):
        v, k = _flow_value(first, lines, 1)
    else:
        v, k = _block(lines, 0, lines[0][0])
    if k != len(lines):
        raise YAMLSubsetError(f"unexpected line: {lines[k][1]!r}")
    return v


def load_file(path: str) -> Any:
    with open(path, "r") as f:
        return load(f.read())


# ------------------------------------------------------------------ writing

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
        r = repr(v).lower()
        if "." not in r and "e" in r:   # PyYAML's form: a dot before the exponent
            r = r.replace("e", ".0e", 1)
        return r
    if isinstance(v, str):
        plain_ok = (v == v.strip() and v != "" and resolve_scalar(v) == v
                    and not re.search(r"[:#,\[\]{}]|^[-?!&*|>'\"%@`]", v)
                    and "\n" not in v)
        return v if plain_ok else "'" + v.replace("'", "''") + "'"
    raise YAMLSubsetError(f"cannot write a {type(v).__name__} in the subset")


def _emit(v: Any, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key in sorted(v):
        item = v[key]
        k = _scalar(key)
        if isinstance(item, dict) and item:
            out.append(f"{pad}{k}:")
            _emit(item, indent + 2, out)
        elif isinstance(item, (list, tuple)) and item:
            out.append(f"{pad}{k}:")
            for e in item:
                if isinstance(e, (dict, list, tuple)):
                    raise YAMLSubsetError("nested collections in lists are not in the subset")
                out.append(f"{pad}- {_scalar(e)}")
        elif isinstance(item, dict):
            out.append(f"{pad}{k}: {{}}")
        elif isinstance(item, (list, tuple)):
            out.append(f"{pad}{k}: []")
        else:
            out.append(f"{pad}{k}: {_scalar(item)}")


def dump(data: dict) -> str:
    """A mapping in block style, keys sorted (as `yaml.safe_dump` with
    default_flow_style=False writes it, up to quoting)."""
    if not isinstance(data, dict):
        raise YAMLSubsetError("dump writes a mapping")
    out: List[str] = []
    _emit(data, 0, out)
    return "\n".join(out) + "\n" if out else "{}\n"


def dump_file(data: dict, path: str) -> None:
    with open(path, "w") as f:
        f.write(dump(data))
