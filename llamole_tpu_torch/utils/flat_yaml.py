"""Flat YAML mappings (scalars and lists of scalars), read and written by
first-party code with YAML 1.1 scalar rules as PyYAML applies them: the
port's model_config.yaml files and its argument files (config/*.yaml)
need no PyYAML.
"""

import json
import math
import re
from typing import Any, Dict

_NULLS = {"", "~", "null", "Null", "NULL"}
_BOOLS = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                               "on", "On", "ON")},
          **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                                "off", "Off", "OFF")}}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_./-]*$")


def _yaml_scalar(v: Any) -> str:
    """One scalar as PyYAML's yaml.dump writes it."""
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
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e")
        return text
    if isinstance(v, str):
        if _PLAIN.match(v) and _read_scalar(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to model_config.yaml")


def _read_scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    low = text.lower()
    if low in (".inf", "+.inf", "-.inf"):
        return -math.inf if low.startswith("-") else math.inf
    if low == ".nan":
        return math.nan
    return text


def dump_flat_yaml(mapping: Dict[str, Any]) -> str:
    """A flat mapping (scalars, lists of scalars) in yaml.dump's layout:
    keys sorted, lists in block style."""
    lines = []
    for key in sorted(mapping):
        v = mapping[key]
        if isinstance(v, (list, tuple)):
            lines.append(f"{key}:" if v else f"{key}: []")
            lines += [f"- {_yaml_scalar(x)}" for x in v]
        else:
            lines.append(f"{key}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one at the start, or after a
    blank, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t:[,-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_flat_yaml(text: str) -> Dict[str, Any]:
    """What yaml.safe_load gives for a flat mapping of scalars and lists
    of scalars (block `- x` items or a flow `[a, b]`), comments
    dropped."""
    out: Dict[str, Any] = {}
    open_key = None     # a `key:` with no value: null, or a block list
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        stripped = line.lstrip()
        if stripped.startswith("- ") or stripped == "-":
            if open_key is None:
                raise ValueError(f"list item outside a list: {raw!r}")
            out[open_key] = (out[open_key] or []) + [
                _read_scalar(stripped[1:])]
            continue
        if line[0] in " \t" or ":" not in line:
            raise ValueError(f"not a flat YAML mapping line: {raw!r}")
        key, _, value = line.partition(":")
        key, value = key.strip(), value.strip()
        open_key = None
        if value.startswith("[") and value.endswith("]"):
            inner = value[1:-1].strip()
            out[key] = ([_read_scalar(x) for x in inner.split(",")]
                        if inner else [])
        elif value:
            out[key] = _read_scalar(value)
        else:
            out[key] = None
            open_key = key
    return out
