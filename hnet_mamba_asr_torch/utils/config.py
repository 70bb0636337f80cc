"""Config system: YAML files + CLI dotlist overrides -> plain nested dicts.

Counterpart of ``hnet_mamba_asr_tpu/utils/config.py`` with the same
functions and results. The card's machine has no PyYAML, so the YAML comes
from a reader of this module's own, ``loads``. It reads the subset that the
repository's configs use and gives what ``yaml.safe_load`` gives for it:

- block mappings and sequences (a sequence may sit at its key's indent),
  ``- key: value`` items, ``- {...}`` / ``- [...]`` items;
- flow sequences and mappings, nested, and spanning lines;
- ``#`` comments, plain and single- or double-quoted scalars, one leading
  ``---``;
- PyYAML's YAML 1.1 scalar rules: ``1.0e-3`` is a float and ``1e-3`` a
  string, ``null`` / ``~`` / empty are None, ``yes`` / ``no`` / ``on`` /
  ``off`` / ``true`` / ``false`` bools, ``0x1F`` / ``017`` / ``1_000`` /
  ``1:30`` ints, ``.inf`` / ``.nan`` floats.

Everything else (anchors and aliases, tags, block scalars, multi-line plain
or quoted scalars, complex keys, several documents, dates and timestamps,
merge keys, tabs in indentation) raises ``YAMLSubsetError`` with the line
number. The reader never guesses.
"""
from __future__ import annotations

import copy
import hashlib
import json
import re
from pathlib import Path
from typing import Any, Mapping, Sequence


class YAMLSubsetError(ValueError):
    """A YAML text outside the reader's subset, or malformed."""


# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order
_BOOL_RE = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_WS = " \t"
_FLOW = ",[]{}"


def _sexagesimal(text: str, cast):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _resolve_plain(text: str, line: int) -> Any:
    """A plain (unquoted) scalar -> its value under PyYAML's resolvers."""
    if _BOOL_RE.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if text == "<<":
        raise YAMLSubsetError(f"line {line}: merge keys (<<) are outside the subset")
    if _NULL_RE.match(text):
        return None
    if _TIMESTAMP_RE.match(text):
        raise YAMLSubsetError(f"line {line}: dates and timestamps are outside the subset: "
                              f"{text!r}")
    if text == "=":
        raise YAMLSubsetError(f"line {line}: the value key (=) is outside the subset")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(text: str, no: int) -> tuple[str, int]:
    """-> (the text before a ``#`` comment, the flow depth at its end).
    Quotes must close on their line."""
    quote, depth = None, 0
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c == "#" and (i == 0 or text[i - 1] in _WS):
            return text[:i].rstrip(), depth
        elif c in "'\"" and (i == 0 or text[i - 1] in _WS + "[{,:-?"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    if quote is not None:
        raise YAMLSubsetError(f"line {no}: a quoted scalar that spans lines is outside "
                              "the subset")
    return text.rstrip(), depth


def _logical_lines(text: str) -> list[_Line]:
    """Lines with their indent and without comments; a flow collection that
    spans lines is joined into its first line (line breaks fold to spaces)."""
    out: list[_Line] = []
    raw = text.lstrip("﻿").splitlines()
    i, seen_doc = 0, False
    while i < len(raw):
        no, line = i + 1, raw[i]
        i += 1
        body = line.lstrip(" ")
        if body.startswith("\t") and body.strip():
            raise YAMLSubsetError(f"line {no}: a tab in the indentation")
        content, depth = _strip_comment(body, no)
        if not content.strip():
            continue
        indent = len(line) - len(body)
        if content.rstrip() == "---" and indent == 0:
            if seen_doc or out:
                raise YAMLSubsetError(f"line {no}: more than one document")
            seen_doc = True
            continue
        if indent == 0 and (content.startswith("---") or content.startswith("...")
                            or content.startswith("%")):
            raise YAMLSubsetError(f"line {no}: document markers and directives are "
                                  "outside the subset")
        while depth > 0:
            if i >= len(raw):
                raise YAMLSubsetError(f"line {no}: a flow collection is not closed")
            nxt, depth_more = _strip_comment(raw[i].strip(), i + 1)
            if not nxt:
                raise YAMLSubsetError(f"line {i + 1}: a blank or comment line inside a "
                                      f"flow collection (opened on line {no})")
            content = content + " " + nxt
            depth += depth_more
            i += 1
        if depth < 0:
            raise YAMLSubsetError(f"line {no}: an unmatched ']' or '}}'")
        out.append(_Line(no, indent, content))
    return out


def _is_dash(text: str) -> bool:
    return text == "-" or text[:2] in ("- ", "-\t")


def _find_colon(text: str) -> int:
    """Index of the mapping separator (``:`` then whitespace or the end)
    outside quotes and flow collections, or -1."""
    quote, depth, i = None, 0, 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in _WS + "[{,"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(text) or text[i + 1] in _WS):
            return i
        i += 1
    return -1


class _Flow:
    """Recursive descent over one logical line: flow collections and scalars."""

    def __init__(self, text: str, no: int, flow: bool):
        self.s, self.i, self.no, self.flow = text, 0, no, flow

    def fail(self, msg: str):
        raise YAMLSubsetError(f"line {self.no}: {msg}: {self.s!r}")

    def ws(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in _WS:
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def at_colon(self) -> bool:
        nxt = self.s[self.i + 1:self.i + 2]
        return self.peek() == ":" and (nxt == "" or nxt in _WS
                                       or (self.flow and nxt in _FLOW))

    def node(self) -> Any:
        self.ws()
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in "'\"":
            return self.quoted()
        return self.plain()

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.peek() == "]":
                self.i += 1
                return out
            item = self.node()
            self.ws()
            if self.at_colon():
                self.fail("a single-pair mapping in a flow sequence is outside the subset")
            out.append(item)
            if not self.sep("]"):
                return out

    def map(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.ws()
            if self.peek() == "}":
                self.i += 1
                return out
            if self.peek() in "[{":
                self.fail("a collection as a mapping key is outside the subset")
            key = self.node()
            self.ws()
            value = None
            if self.at_colon():
                self.i += 1
                self.ws()
                if self.peek() not in (",", "}"):
                    value = self.node()
            out[key] = value
            if not self.sep("}"):
                return out

    def sep(self, close: str) -> bool:
        """After an entry: True at ``,``, False at the closing bracket."""
        self.ws()
        c = self.peek()
        self.i += 1
        if c == ",":
            return True
        if c == close:
            return False
        self.fail(f"expected ',' or {close!r}")

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                    continue
                if e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.i + 2:self.i + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9A-Fa-f]+", digits):
                        self.fail(f"a bad \\{e} escape")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + n
                    continue
                self.fail(f"an unknown escape \\{e}")
            out.append(c)
            self.i += 1
        self.fail("a quoted scalar is not closed")

    def plain(self) -> Any:
        c = self.peek()
        if c == "" or (c in "]},"):
            return None if c == "" or self.flow else self.fail(f"unexpected {c!r}")
        if c in "&*!|>%@`" or (c in "?:-" and self.s[self.i + 1:self.i + 2] in ("", " ", "\t")):
            self.fail(f"{c!r} (an anchor, alias, tag, block scalar, complex key or "
                      "reserved indicator) is outside the subset")
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if self.flow and c in ",[]{}":
                break
            if self.flow and c == "?":
                self.fail("'?' in a flow scalar is outside the subset")
            if self.at_colon():
                break
            self.i += 1
        return _resolve_plain(self.s[start:self.i].rstrip(), self.no)

    def done(self) -> None:
        self.ws()
        if self.i != len(self.s):
            if self.peek() == ":":
                self.fail("a mapping value is not allowed here")
            self.fail("unexpected text after the value")


def _inline(text: str, no: int) -> Any:
    """The value on one logical line: a flow collection or a scalar."""
    p = _Flow(text, no, flow=text[:1] in "[{")
    value = p.node()
    p.done()
    return value


class _Block:
    def __init__(self, lines: list[_Line]):
        self.lines = lines

    def indent(self, i: int) -> int:
        return self.lines[i].indent if i < len(self.lines) else -1

    def node(self, i: int, indent: int) -> tuple[Any, int]:
        """The block node whose first line is ``i`` (at ``indent``)."""
        line = self.lines[i]
        if _is_dash(line.text):
            return self.seq(i, indent)
        if _find_colon(line.text) >= 0:
            return self.map(i, indent)
        value = _inline(line.text, line.no)
        if self.indent(i + 1) > indent:
            raise YAMLSubsetError(f"line {self.lines[i + 1].no}: a continuation line (a "
                                  "multi-line scalar) is outside the subset")
        return value, i + 1

    def child(self, i: int, indent: int) -> tuple[Any, int]:
        """The value of a key or dash with nothing after it on its line."""
        nxt = self.indent(i)
        if nxt > indent:
            return self.node(i, nxt)
        return None, i

    def seq(self, i: int, indent: int) -> tuple[list, int]:
        out = []
        while self.indent(i) == indent and _is_dash(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:]
            body = rest.lstrip(_WS)
            if not body:
                value, i = self.child(i + 1, indent)
            else:
                sub = indent + 1 + len(rest) - len(body)
                self.lines[i] = _Line(line.no, sub, body)   # the item as its own line
                value, i = self.node(i, sub)
            out.append(value)
        if self.indent(i) > indent:
            raise YAMLSubsetError(f"line {self.lines[i].no}: bad indentation in a sequence")
        return out, i

    def map(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while self.indent(i) == indent and not _is_dash(self.lines[i].text):
            line = self.lines[i]
            k = _find_colon(line.text)
            if k < 0:
                raise YAMLSubsetError(f"line {line.no}: expected 'key: value': "
                                      f"{line.text!r}")
            key_text, rest = line.text[:k].strip(), line.text[k + 1:].strip(_WS)
            if not key_text or key_text[0] in "[{":
                raise YAMLSubsetError(f"line {line.no}: an empty or collection key is "
                                      "outside the subset")
            key = _inline(key_text, line.no)
            if rest:
                value = _inline(rest, line.no)
                i += 1
                if self.indent(i) > indent:
                    raise YAMLSubsetError(f"line {self.lines[i].no}: a continuation line "
                                          "(a multi-line scalar) is outside the subset")
            elif self.indent(i + 1) == indent and _is_dash(self.lines[i + 1].text):
                value, i = self.seq(i + 1, indent)       # a sequence at its key's indent
            else:
                value, i = self.child(i + 1, indent)
            try:
                out[key] = value                         # a repeated key: the last wins
            except TypeError:
                raise YAMLSubsetError(f"line {line.no}: unhashable key {key!r}") from None
        if self.indent(i) > indent:
            raise YAMLSubsetError(f"line {self.lines[i].no}: bad indentation in a mapping")
        return out, i


def loads(text: str, name: str = "<string>") -> Any:
    """A YAML text -> its value, as ``yaml.safe_load`` gives it, for the
    subset of the module docstring; anything else raises YAMLSubsetError
    naming ``name`` and the line."""
    try:
        lines = _logical_lines(text)
        if not lines:
            return None
        block = _Block(lines)
        value, i = block.node(0, lines[0].indent)
        if i != len(lines):
            raise YAMLSubsetError(f"line {lines[i].no}: unexpected text at a lower indent "
                                  "than its block")
        return value
    except YAMLSubsetError as e:
        raise YAMLSubsetError(f"{name}: {e}") from None


def load_yaml(path: str | Path) -> dict:
    with open(path, encoding="utf-8") as f:
        out = loads(f.read(), str(path))
    return out or {}


def deep_merge(base: dict, extra: Mapping) -> dict:
    """Recursively merge ``extra`` into a copy of ``base`` (extra wins)."""
    out = copy.deepcopy(dict(base))
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_value(text: str) -> Any:
    """Parse a dotlist RHS: int/float first (so '1e-3' is a float — YAML 1.1
    would keep it a string), then YAML scalar semantics ('null'->None, lists...)."""
    s = text.strip()
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    try:
        return loads(s)
    except YAMLSubsetError:
        return text


def set_dotted(cfg: dict, key: str, value: Any) -> None:
    """Set ``a.b.c`` in a nested dict, creating intermediate dicts."""
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        nxt = node.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            node[p] = nxt
        node = nxt
    node[parts[-1]] = value


def apply_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """Apply ``key.path=value`` strings on top of cfg (returns a new dict)."""
    out = copy.deepcopy(cfg)
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, _, raw = item.partition("=")
        set_dotted(out, key.strip(), parse_value(raw))
    return out


def load_config(path: str | Path, overrides: Sequence[str] = ()) -> dict:
    """YAML file + dotlist overrides -> resolved plain dict."""
    return apply_overrides(load_yaml(path), overrides)


def config_fingerprint(cfg: Mapping) -> str:
    """Stable short hash of a resolved config (provenance)."""
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


# the flat key each pinned Trainer setting reads, and the level it comes from
_PINNED = {
    "max_epoch": ("train", 120), "grad_clip": ("train", 5.0),
    "grad_clip_type": ("train", 2.0), "precision": ("train", "bf16"),
    "log_interval": ("train", 50), "max_steps": ("train", None),
    "scan_steps": ("train", 1), "tp": ("train", 1), "ckpt_backend": ("train", "pickle"),
    "accum_grad": ("top", 1), "valid_interval_epoch": ("eval", 10),
    "keep_nbest_models": ("top", 5), "keep_all_checkpoints": ("top", False),
    "best_model_criterion": ("top", [["valid", "loss", "min"]]),
    "early_stopping": ("top", {}), "optim": ("top", "adamw"), "optim_conf": ("top", {}),
    "scheduler": ("top", None), "scheduler_conf": ("top", {}),
}
_OR_EMPTY = ("early_stopping", "optim_conf", "scheduler_conf")   # a None becomes {}


def flatten_config(cfg: Mapping[str, Any]) -> dict:
    """Nested YAML -> the flat key set the Trainer reads (train.*/eval.*
    hoisted), as the JAX package's ``flatten_config``: the pinned keys with
    their defaults, then every other train.* / eval.* key as it is. A key in
    both blocks, or a block key that contradicts the level its pinned key
    comes from, raises."""
    c = dict(cfg)
    levels = {"train": c.get("train", {}) or {}, "eval": c.get("eval", {}) or {}, "top": c}
    out = {}
    for k, (level, default) in _PINNED.items():
        v = copy.deepcopy(default) if k not in levels[level] else levels[level][k]
        out[k] = (v or {}) if k in _OR_EMPTY else v
    clash = set(levels["train"]) & set(levels["eval"])
    if clash:
        raise ValueError(
            f"config keys appear in BOTH train: and eval: blocks: "
            f"{sorted(clash)} — the Trainer reads one flat namespace; move "
            f"each key to exactly one block")
    for src_name in ("train", "eval"):
        for k, v in levels[src_name].items():
            pin = _PINNED.get(k, (None,))[0]
            if pin is None or pin == src_name:
                out.setdefault(k, v)
                continue
            canonical = levels[pin]
            if k in canonical and canonical[k] != v:
                where = "top-level" if pin == "top" else f"{pin}: block"
                raise ValueError(
                    f"{src_name}.{k}={v!r} contradicts the {where} "
                    f"{k}={canonical[k]!r} — set it in exactly one place")
            out[k] = v
    return out
