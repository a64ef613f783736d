"""Config system: YAML ∪ CLI dotlist → nested attribute dicts → dataclasses.

Counterpart of ``triplaneturbo_tpu/utils/config.py``. :func:`load_config`
merges a YAML file (with single inheritance through ``__base__``), dotlist
overrides (``system.loss.lambda_sdf=0.1``) and keyword arguments, resolves the
``${...}`` interpolations and the resolvers (``rmspace``, ``cmaxgt0``, ...),
and computes the trial directory; :func:`parse_structured` builds a dataclass
from a dict.

The port reads YAML without PyYAML: :func:`yaml_load` parses the subset the
configs use (block mappings, flow lists and maps, plain and quoted scalars,
comments) and resolves plain scalars as ``yaml.safe_load`` does (YAML 1.1:
``1.0e-15`` is a float, ``1e-15`` a string; ``yes``/``on`` are booleans).
:func:`dump_config` writes JSON, which is YAML too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import typing
from datetime import datetime
from typing import Any, Dict, List, Optional, Tuple, Union


class DotDict(dict):
    """dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, k: str) -> Any:
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        if isinstance(v, dict) and not isinstance(v, DotDict):
            v = DotDict(v)
            self[k] = v
        return v

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def __deepcopy__(self, memo):
        import copy

        return DotDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return DotDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


# --- the YAML subset ----------------------------------------------------------


class YAMLError(ValueError):
    pass


# the YAML 1.1 implicit resolvers of PyYAML's SafeLoader
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)")
_FLOAT_RE = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")


def _resolve_plain(s: str) -> Any:
    """A plain (unquoted) scalar's value: null, bool, int, float or the string."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT_RE.fullmatch(s):
        body = s.replace("_", "")
        sign = -1 if body[0] == "-" else 1
        body = body.lstrip("+-")
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if len(body) > 1 and body[0] == "0":
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT_RE.fullmatch(s):
        body = s.replace("_", "").lower()
        if body.endswith("inf"):
            return float("-inf") if body[0] == "-" else float("inf")
        if body.endswith("nan"):
            return float("nan")
        return float(body)
    return s


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0"}


class _Flow:
    """Recursive-descent reader of one flow node (``[...]``, ``{...}`` or a scalar)
    in ``text`` from ``pos``."""

    def __init__(self, text: str, pos: int = 0):
        self.text, self.pos = text, pos

    def _ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def node(self, in_flow: bool) -> Any:
        self._ws()
        c = self._peek()
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "\"'":
            return self._quoted()
        return self._plain(in_flow)

    def _seq(self) -> list:
        self.pos += 1
        out = []
        while True:
            self._ws()
            if self._peek() == "]":
                self.pos += 1
                return out
            out.append(self.node(True))
            self._ws()
            c = self._peek()
            self.pos += 1
            if c == "]":
                return out
            if c != ",":
                raise YAMLError(f"expected ',' or ']' in a flow sequence: {self.text!r}")

    def _map(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self._ws()
            if self._peek() == "}":
                self.pos += 1
                return out
            key = self.node(True)
            self._ws()
            if self._peek() != ":":
                raise YAMLError(f"expected ':' in a flow mapping: {self.text!r}")
            self.pos += 1
            out[key] = self.node(True)
            self._ws()
            c = self._peek()
            self.pos += 1
            if c == "}":
                return out
            if c != ",":
                raise YAMLError(f"expected ',' or '}}' in a flow mapping: {self.text!r}")

    def _quoted(self) -> str:
        q = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                raise YAMLError(f"unterminated quoted scalar: {self.text!r}")
            c = self.text[self.pos]
            if q == "'" and c == "'":
                if self.text[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.pos += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.text[self.pos + 1:self.pos + 2]
                if e in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[e]
                    out.append(chr(int(self.text[self.pos + 2:self.pos + 2 + n], 16)))
                    self.pos += 2 + n
                    continue
                if e not in _ESCAPES:
                    raise YAMLError(f"unknown escape \\{e} in {self.text!r}")
                out.append(_ESCAPES[e])
                self.pos += 2
                continue
            out.append(c)
            self.pos += 1

    def _plain(self, in_flow: bool) -> Any:
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if in_flow and c in ",[]{}":
                break
            if c == ":" and (self.pos + 1 == len(self.text) or self.text[self.pos + 1] in " \t"
                             or (in_flow and self.text[self.pos + 1] in ",[]{}")):
                break
            if c == "#" and self.pos > start and self.text[self.pos - 1] in " \t":
                break
            self.pos += 1
        return _resolve_plain(self.text[start:self.pos].strip())


def _strip_comment(line: str) -> str:
    """``line`` without a comment: a ``#`` at its start or after a blank, outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(content: str) -> Tuple[Any, str]:
    """(key, rest) of a block mapping entry ``key: rest``."""
    flow = _Flow(content)
    c = content[:1]
    if c in "\"'":
        key = flow._quoted()
    else:
        i = 0
        while True:
            i = content.find(":", i)
            if i < 0:
                raise YAMLError(f"expected 'key: value', got {content!r}")
            if i + 1 == len(content) or content[i + 1] in " \t":
                break
            i += 1
        key = _resolve_plain(content[:i].strip())
        flow.pos = i
    flow._ws()
    if flow._peek() != ":":
        raise YAMLError(f"expected ':' after the key in {content!r}")
    return key, content[flow.pos + 1:].strip()


def _value(text: str) -> Any:
    """A value on one line: a flow collection, a quoted or a plain scalar."""
    flow = _Flow(text)
    v = flow.node(in_flow=False)
    flow._ws()
    if flow.pos != len(text):
        raise YAMLError(f"unexpected text after the value: {text!r}")
    return v


def yaml_load(text: str) -> Any:
    """Parse the YAML subset of the repo's configs: nested block mappings whose values
    are scalars or single-line flow collections. Returns None for an empty document."""
    if text.lstrip()[:1] in ("{", "["):
        try:  # a JSON document, as dump_config writes
            return json.loads(text)
        except ValueError:
            pass
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLError(f"tab in the indentation: {raw!r}")
        s = _strip_comment(raw).rstrip()
        if s.strip():
            lines.append((len(s) - len(s.lstrip(" ")), s.strip()))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1][:1] in "[{\"'":
        return _value(lines[0][1])

    def block(i: int, indent: int) -> Tuple[dict, int]:
        out: Dict[Any, Any] = {}
        while i < len(lines) and lines[i][0] >= indent:
            ind, content = lines[i]
            if ind != indent:
                raise YAMLError(f"bad indentation at {content!r}")
            if content.startswith("- ") or content == "-":
                raise YAMLError(f"block sequences are not in the subset: {content!r}")
            key, rest = _split_key(content)
            if key in out:
                raise YAMLError(f"duplicate key {key!r}")
            i += 1
            if rest:
                out[key] = _value(rest)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    out, i = block(0, lines[0][0])
    if i != len(lines):
        raise YAMLError(f"bad indentation at {lines[i][1]!r}")
    return out


def _read_yaml(path: str) -> Dict:
    with open(path) as f:
        return yaml_load(f.read()) or {}


def _parse_value(s: str) -> Any:
    """A CLI override value or a resolver argument, read with YAML's rules."""
    try:
        v = _value(s.strip())
    except (YAMLError, IndexError, ValueError):
        return s
    if v is None and s.strip() not in ("", "null", "~", "None"):
        return s
    return v


def merge_dicts(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def apply_dotlist(cfg: Dict, dotlist: List[str]) -> Dict:
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Override '{item}' is not of the form key.path=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"Cannot override non-dict node at '{p}' in '{key}'")
        node[parts[-1]] = _parse_value(value)
    return cfg


# --- resolvers ----------------------------------------------------------------


def _resolver_rmspace(s: str, sub: str = "-") -> str:
    return re.sub(r"\s+", sub, str(s).strip())


def _resolver_basename(p: str) -> str:
    return os.path.splitext(os.path.basename(str(p)))[0]


_RESOLVERS = {
    "rmspace": _resolver_rmspace,
    "basename": _resolver_basename,
    "cmaxgt0": lambda v: max(float(v), 0.0) > 0,
    "not": lambda v: not v,
    "add": lambda a, b: float(a) + float(b),
    "sub": lambda a, b: float(a) - float(b),
    "mul": lambda a, b: float(a) * float(b),
    "div": lambda a, b: float(a) / float(b),
    "idiv": lambda a, b: int(a) // int(b),
}

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _lookup(root: Dict, path: str) -> Any:
    node: Any = root
    for p in path.split("."):
        node = node[p] if isinstance(node, dict) else getattr(node, p)
    return node


def _has_path(root: Dict, path: str) -> bool:
    try:
        _lookup(root, path)
        return True
    except (KeyError, AttributeError, TypeError):
        return False


def _resolve_expr(expr: str, root: Dict) -> Any:
    expr = expr.strip()
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            args = [a.strip() for a in argstr.split(",")] if argstr else []
            args = [_lookup(root, a) if re.fullmatch(r"[A-Za-z_][\w.]*", a) and _has_path(root, a)
                    else _parse_value(a) for a in args]
            return _RESOLVERS[name](*args)
    return _lookup(root, expr)


def resolve_interpolations(cfg: Dict, root: Optional[Dict] = None, _depth: int = 0) -> Dict:
    """Resolve ``${path}`` and ``${resolver:args}`` interpolations."""
    if root is None:
        root = cfg
    if _depth > 8:
        return cfg
    changed = [False]

    def resolve_str(s: str) -> Any:
        m = _INTERP_RE.fullmatch(s.strip())
        if m:
            changed[0] = True
            return _resolve_expr(m.group(1), root)

        def sub(mm):
            changed[0] = True
            return str(_resolve_expr(mm.group(1), root))

        return _INTERP_RE.sub(sub, s)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return type(node)({k: walk(v) for k, v in node.items()})
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    out = walk(cfg)
    if changed[0]:
        return resolve_interpolations(out, out, _depth + 1)
    return out


def load_config(path_or_dict: Union[str, Dict], cli_args: Optional[List[str]] = None,
                n_devices: int = 1, **kwargs) -> DotDict:
    """Config = YAML ∪ dotlist ∪ kwargs, interpolations resolved; ``n_devices``, a
    timestamp, ``name``, ``tag``, ``exp_root_dir``, ``seed`` and the trial directory
    filled in where the config leaves them out. ``__base__: path.yaml`` (relative to
    the working directory) is merged under the file."""
    cfg = _read_yaml(path_or_dict) if isinstance(path_or_dict, str) else dict(path_or_dict)
    base_path = cfg.pop("__base__", None)
    if base_path:
        base = _read_yaml(base_path)
        base.pop("__base__", None)
        cfg = merge_dicts(base, cfg)
    if cli_args:
        cfg = apply_dotlist(cfg, list(cli_args))
    if kwargs:
        cfg = merge_dicts(cfg, kwargs)
    cfg.setdefault("n_devices", n_devices)
    cfg.setdefault("timestamp", datetime.now().strftime("@%Y%m%d-%H%M%S"))
    cfg = _wrap(resolve_interpolations(cfg))
    cfg.setdefault("name", "default")
    cfg.setdefault("tag", "")
    cfg.setdefault("exp_root_dir", "outputs")
    cfg.setdefault("seed", 0)
    trial_name = f"{cfg.tag}{cfg.timestamp}" if cfg.get("use_timestamp", True) else cfg.tag
    cfg.setdefault("trial_name", trial_name)
    cfg.setdefault("exp_dir", os.path.join(cfg.exp_root_dir, cfg.name))
    cfg.setdefault("trial_dir", os.path.join(cfg.exp_dir, cfg.trial_name))
    return cfg


def parse_structured(cls, cfg: Optional[Union[Dict, DotDict]] = None, strict: bool = False):
    """Dataclass ``cls`` from dict ``cfg``: unknown keys raise when ``strict``, else
    are dropped; lists become tuples where the field is a tuple, and dicts become the
    field's dataclass."""
    cfg = dict(cfg or {})
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(cfg) - names
    if unknown and strict:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {k: v for k, v in cfg.items() if k in names}
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    for k, v in list(kwargs.items()):
        hint = hints.get(k)
        if (typing.get_origin(hint) is tuple or hint is tuple) and isinstance(v, list):
            kwargs[k] = tuple(v)
        elif dataclasses.is_dataclass(hint) and isinstance(v, dict):
            kwargs[k] = parse_structured(hint, v, strict=strict)
    return cls(**kwargs)


def config_to_primitive(cfg: Any) -> Any:
    if isinstance(cfg, dict):
        return {k: config_to_primitive(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [config_to_primitive(v) for v in cfg]
    if dataclasses.is_dataclass(cfg):
        return config_to_primitive(dataclasses.asdict(cfg))
    return cfg


def dump_config(path: str, cfg: Any) -> None:
    """Write ``cfg`` as JSON (a YAML document that :func:`yaml_load` reads back)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(config_to_primitive(cfg), f, indent=2)
        f.write("\n")
