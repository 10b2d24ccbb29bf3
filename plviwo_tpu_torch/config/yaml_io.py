"""Layered YAML configuration loading (port of plviwo_tpu/config/yaml_io.py).

The reference's config system (`ov_core::YamlParser` and the option structs'
load()): a master `config.yaml` may point at per-domain files

    config.yaml:
        config_files: [config_estimator.yaml, config_camera.yaml, ...]

whose keys map onto the `Options` dataclass tree by nesting (`est:` /
`cam:` / `n_pts: 150`).  Unknown keys are collected and raise with
`strict=True` (the reference exits on unparsed keys, run_bag.cpp:168-171).

The files are read by this module's own parser of the YAML subset the
configurations use, without PyYAML: block mappings nested by indentation,
block sequences, flow lists (nested, and spanning lines), comments, plain
and quoted scalars resolved as YAML 1.1 resolves them (`yaml.safe_load`:
null, booleans, integers, floats, strings).  Anything else (flow mappings,
anchors, multi-line strings, documents markers, tabs) raises, naming the
file and line.
"""

from __future__ import annotations

import dataclasses
import os
import re

from .options import Options

# YAML 1.1's implicit scalar types, as yaml.safe_load resolves them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")


class YamlError(ValueError):
    pass


def _resolve(text: str, where: str):
    """A plain scalar's value, as YAML 1.1 resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _SEXAGESIMAL.match(text):
        raise YamlError(f"{where}: base-60 number {text!r} is not supported")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t != "0" and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    if text[0] in "&*!|>%@`{}":
        raise YamlError(f"{where}: unsupported YAML construct {text!r}")
    return text


def _scalar(text: str, where: str):
    """A scalar: quoted (a string) or plain (resolved)."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise YamlError(f"{where}: escapes in double-quoted strings are not supported")
        return body
    if text[:1] in "'\"":
        raise YamlError(f"{where}: unterminated string {text!r}")
    return _resolve(text, where)


def _flow(text: str, where: str):
    """A flow node: a (nested) list `[a, [b, c]]` or a scalar."""
    text = text.strip()
    if not text.startswith("["):
        return _scalar(text, where)
    stack, items, tok = [[]], None, ""
    for i, ch in enumerate(text):
        if ch == "[":
            if tok.strip():
                raise YamlError(f"{where}: unexpected '[' after {tok.strip()!r}")
            stack.append([])
            tok = ""
        elif ch in ",]":
            if tok.strip():
                stack[-1].append(_scalar(tok, where))
            elif ch == "," and (items is None or items is not stack[-1]):
                raise YamlError(f"{where}: empty entry in {text!r}")
            tok, items = "", None
            if ch == "]":
                if len(stack) < 2:
                    raise YamlError(f"{where}: unbalanced ']' in {text!r}")
                done = stack.pop()
                stack[-1].append(done)
                items = stack[-1]  # a list just closed: a ',' may follow
                if len(stack) == 1 and text[i + 1:].strip():
                    raise YamlError(f"{where}: text after the list in {text!r}")
        elif ch in "{}":
            raise YamlError(f"{where}: flow mappings are not supported")
        else:
            tok += ch
    if len(stack) != 1 or len(stack[0]) != 1:
        raise YamlError(f"{where}: unbalanced '[' in {text!r}")
    return stack[0][0]


def _strip_comment(line: str) -> str:
    """line without its comment: '#' at the start or after a blank, outside
    quotes."""
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


def _logical_lines(text: str, path: str):
    """(indent, content, where) per logical line: comments and blank lines
    dropped, a flow list's continuation lines joined to its first."""
    out, pending = [], None
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        where = f"{path}:{n}"
        if pending is not None:
            pending[1] += " " + line.strip()
            if pending[1].count("[") <= pending[1].count("]"):
                out.append(tuple(pending))
                pending = None
            continue
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
            raise YamlError(f"{where}: tab in the indentation")
        if body.startswith(("---", "...")) or body.startswith("%"):
            raise YamlError(f"{where}: document markers and directives are not supported")
        entry = [len(line) - len(body), body, where]
        if body.count("[") > body.count("]"):
            pending = entry
        else:
            out.append(tuple(entry))
    if pending is not None:
        raise YamlError(f"{pending[2]}: unbalanced '[' to the end of the file")
    return out


def _is_item(body: str) -> bool:
    return body == "-" or body.startswith("- ")


def _split_key(body: str, where: str):
    """(key, rest) of a mapping entry `key: rest`."""
    m = re.match(r"^((?:'[^']*'|\"[^\"]*\"|[^'\"#]*?)):(?:\s+(.*))?$", body)
    if m is None or not m.group(1).strip():
        raise YamlError(f"{where}: cannot parse {body!r} (expected 'key: value')")
    return _scalar(m.group(1), where), (m.group(2) or "").strip()


def _block(lines, i: int, indent: int):
    """The node whose first line is lines[i], at that line's indentation
    (deeper than `indent`, or equal for a sequence under a key).  Returns
    (node, index of the next line)."""
    ind, body, where = lines[i]
    if ind < indent:
        raise YamlError(f"{where}: bad indentation")
    seq = _is_item(body)
    node = [] if seq else {}
    while i < len(lines):
        ind_i, body, where = lines[i]
        if ind_i < ind:
            break
        if ind_i > ind:
            raise YamlError(f"{where}: bad indentation")
        if _is_item(body) != seq:
            if seq:  # the mapping that holds this sequence goes on
                break
            raise YamlError(f"{where}: a sequence item inside a mapping")
        if seq:
            rest = body[1:].strip()
            if rest:
                if re.match(r"^[^'\"\[]*?:(\s|$)", rest):
                    raise YamlError(f"{where}: mappings inside sequence items are not supported")
                node.append(_flow(rest, where))
                i += 1
            elif i + 1 < len(lines) and lines[i + 1][0] > ind:
                child, i = _block(lines, i + 1, ind + 1)
                node.append(child)
            else:
                node.append(None)
                i += 1
            continue
        key, rest = _split_key(body, where)
        i += 1
        if rest:
            node[key] = _flow(rest, where)
        elif i < len(lines) and (lines[i][0] > ind
                                 or (lines[i][0] == ind and _is_item(lines[i][1]))):
            node[key], i = _block(lines, i, ind)
        else:
            node[key] = None
    return node, i


def parse_yaml(text: str, path: str = "<string>"):
    """The YAML subset's document as Python values (yaml.safe_load's result
    on it); an empty document gives None."""
    lines = _logical_lines(text, path)
    if not lines:
        return None
    node, i = _block(lines, 0, 0)
    if i != len(lines):
        raise YamlError(f"{lines[i][2]}: bad indentation")
    return node


def _load_yaml(path):
    with open(path) as f:
        return parse_yaml(f.read(), path) or {}


def _parse_scalar(s):
    """A leaf value as the JAX package coerces it: booleans, numbers and
    one-level bracket lists from strings; lists and numbers as they are."""
    if isinstance(s, (int, float, bool, list)):
        return s
    t = str(s).strip()
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        return [_parse_scalar(x) for x in inner.split(",")] if inner else []
    return t


def _apply(obj, data, prefix, unknown):
    for key, val in data.items():
        if not hasattr(obj, key):
            unknown.append(f"{prefix}{key}")
            continue
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _apply(cur, val, f"{prefix}{key}.", unknown)
        else:
            setattr(obj, key, _parse_scalar(val))


def load_options(path: str, strict: bool = True, base: Options | None = None) -> Options:
    """Load an Options tree from a master YAML and its config_files.

    `base` (mutated in place when given) supplies the defaults that come
    before the YAML, such as a driver's dataset settings; any key the YAML
    sets overrides them (the reference's precedence: struct defaults, then
    YAML, then command-line overrides)."""
    opts = Options() if base is None else base
    data = _load_yaml(path)
    root = os.path.dirname(os.path.abspath(path))
    files = data.pop("config_files", [])
    unknown: list[str] = []
    _apply(opts, data, "", unknown)
    for rel in files:
        _apply(opts, _load_yaml(os.path.join(root, rel)), f"{rel}:", unknown)
    if unknown and strict:
        raise ValueError(f"unparsed config keys: {unknown}")
    return opts
