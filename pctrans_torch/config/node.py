"""YACS-style config node and a reader for the YAML the configs use.

``CfgNode`` is a copy of ``pctrans_tpu/config/node.py``'s: a nested
attribute dict merged from two YAML files and ``--opts KEY VALUE`` pairs,
with unknown ``--opts`` keys raising.  The port reads YAML with its own
reader, since the card's machine has no PyYAML.  It takes the subset the
repository's configs are written in:

* nested block mappings by indentation (spaces), ``#`` comments;
* scalars resolved as PyYAML's ``safe_load`` (YAML 1.1) resolves them:
  ``null``/``~``, the YAML 1.1 booleans, decimal ints, and floats only in
  YAML 1.1's form, so ``1.0e-4`` is a float and ``1e-04`` a string (the
  merge coerces it to the default's type);
* single- and double-quoted strings;
* flow lists ``[a, "b", [1, 2.5]]`` and the empty mapping ``{}``.

Anything else (block sequences, anchors, multi-line scalars) raises
``ValueError`` with the line.  :meth:`CfgNode.dump` writes YAML in this
subset, which this reader and ``yaml.safe_load`` both read back.
"""

from __future__ import annotations

import ast
import copy
import json
import math
import re
from typing import Any, Dict, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
# PyYAML's float pattern (without its base-60 form): a dot is required, and
# an exponent needs its sign
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_KEY = re.compile(r"^([^\s#'\"\[\]{},:-][^:]*?)\s*:(?:\s+(.*))?$")


class CfgNode(dict):
    """Nested attribute dict with yacs-style merge/freeze semantics."""

    _FROZEN = "__frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set {name}: CfgNode is frozen")
        self[name] = (CfgNode(value) if isinstance(value, dict)
                      and not isinstance(value, CfgNode) else value)

    def __setitem__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set {name}: CfgNode is frozen")
        super().__setitem__(name, value)

    def freeze(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    def merge_from_other(self, other: Dict[str, Any], allow_new: bool = True) -> None:
        for k, v in other.items():
            if isinstance(v, dict):
                if k not in self or not isinstance(self[k], CfgNode):
                    if not allow_new and k not in self:
                        raise KeyError(f"Unknown config key: {k}")
                    self[k] = CfgNode()
                self[k].merge_from_other(v, allow_new=allow_new)
            else:
                if not allow_new and k not in self:
                    raise KeyError(f"Unknown config key: {k}")
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, path: str, allow_new: bool = True) -> None:
        with open(path, "r") as f:
            data = load_yaml(f.read()) or {}
        self.merge_from_other(data, allow_new=allow_new)

    def merge_from_list(self, opts: List[str], allow_new: bool = False) -> None:
        """``--opts KEY VALUE ...`` overrides; an unknown key raises."""
        if len(opts) % 2:
            raise ValueError(f"--opts must be KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    if not allow_new:
                        raise KeyError(f"Unknown config key: {key}")
                    node[p] = CfgNode()
                node = node[p]
            if parts[-1] not in node and not allow_new:
                raise KeyError(f"Unknown config key: {key}")
            node[parts[-1]] = _coerce(_parse_literal(value), node.get(parts[-1]))

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v)
                for k, v in self.items()}

    def dump(self) -> str:
        return dump_yaml(self.to_dict())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump())


def _parse_literal(value: Any) -> Any:
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(value: Any, old: Any) -> Any:
    """Coerce parsed values to the type of the default when sensible."""
    if old is None or value is None:
        return value
    if isinstance(old, bool) and isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (int, float)) and isinstance(value, str):
        # YAML 1.1 reads "1e-04" as a string; coerce numeric strings
        try:
            return type(old)(float(value))
        except ValueError:
            return value
    if isinstance(old, tuple) and isinstance(value, (list, str)):
        if isinstance(value, str):
            value = _parse_literal(value)
        return tuple(value) if isinstance(value, (list, tuple)) else (value,)
    if isinstance(old, tuple) and isinstance(value, (int, float)):
        return (value,)
    return value


# ------------------------------------------------------------------ reader
def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _plain(text: str) -> Any:
    """A plain (unquoted) scalar, resolved as YAML 1.1 does."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower()
        if low.endswith(".inf"):
            return -math.inf if low.startswith("-") else math.inf
        if low == ".nan":
            return math.nan
        return float(text.replace("_", ""))
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at ``text[i]``; returns (value, next i)."""
    q = text[i]
    j = i + 1
    while j < len(text):
        if q == "'" and text[j] == "'":
            if text[j + 1:j + 2] == "'":          # '' is an escaped quote
                j += 2
                continue
            return text[i + 1:j].replace("''", "'"), j + 1
        if q == '"' and text[j] == "\\":
            j += 2
            continue
        if q == '"' and text[j] == '"':
            return json.loads(text[i:j + 1]), j + 1
        j += 1
    raise ValueError(f"unterminated quoted string in {text!r}")


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """A flow item at ``text[i]``: a list, a quoted or a plain scalar."""
    while i < len(text) and text[i] == " ":
        i += 1
    if text.startswith("[", i):
        items, i = [], i + 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if text.startswith("]", i):
                return items, i + 1
            item, i = _flow(text, i)
            items.append(item)
            while i < len(text) and text[i] == " ":
                i += 1
            if text.startswith(",", i):
                i += 1
            elif not text.startswith("]", i):
                raise ValueError(f"expected ',' or ']' in {text!r}")
    if i < len(text) and text[i] in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]":
        j += 1
    return _plain(text[i:j].strip()), j


def _value(text: str, lineno: int) -> Any:
    if text == "{}":
        return {}
    if text[0] in "{&*!|>":
        raise ValueError(f"line {lineno}: {text!r} is outside the YAML subset "
                         "the port reads")
    if text[0] in "['\"":
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"line {lineno}: trailing text after {text[:end]!r}")
        return value
    return _plain(text)


def load_yaml(text: str) -> Dict[str, Any]:
    """Parse ``text`` (the subset in the module docstring) into dicts."""
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = []
    pending = None                      # (indent, parent, key) awaiting a block
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        content = line.strip()
        if not content or content in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[:indent + 1].lstrip(" ").startswith("\t"):
            raise ValueError(f"line {lineno}: tab indentation")
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                parent[key] = {}
                stack.append((indent, parent[key]))
            else:
                parent[key] = None
        if not stack:
            stack.append((indent, root))
        while len(stack) > 1 and stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise ValueError(f"line {lineno}: inconsistent indentation")
        m = _KEY.match(content)
        if m is None:
            raise ValueError(f"line {lineno}: {content!r} is not a 'key: value' "
                             "line of the YAML subset the port reads")
        key, rest = m.group(1), (m.group(2) or "").strip()
        node = stack[-1][1]
        if rest:
            node[key] = _value(rest, lineno)
        else:
            pending = (indent, node, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root


# ------------------------------------------------------------------ writer
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
        # YAML 1.1 needs a dot in a float: 1e-07 -> 1.0e-07
        return text if "." in text else text.replace("e", ".0e")
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def dump_yaml(tree: Dict[str, Any], indent: int = 0) -> str:
    """Block mappings with sorted keys; lists in flow style."""
    lines = []
    for k in sorted(tree):
        v = tree[k]
        pad = " " * indent
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{k}:\n{dump_yaml(v, indent + 2)}")
        else:
            lines.append(f"{pad}{k}: {'{}' if isinstance(v, dict) else _scalar(v)}\n")
    return "".join(lines)
