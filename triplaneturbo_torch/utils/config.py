"""Config system: YAML ∪ CLI dotlist → nested attribute dicts → dataclasses.

Counterpart of ``triplaneturbo_tpu/utils/config.py``. :func:`load_config`
merges a YAML file (with single inheritance through ``__base__``), dotlist
overrides (``system.loss.lambda_sdf=0.1``) and keyword arguments, resolves the
``${...}`` interpolations and the resolvers (``rmspace``, ``cmaxgt0``, ...),
and computes the trial directory; :func:`parse_structured` builds a dataclass
from a dict.

YAML is read with ``yaml.safe_load``; :func:`dump_config` writes JSON, which is
YAML too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import typing
from datetime import datetime
from typing import Any, Dict, List, Optional, Union

import yaml


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


def _read_yaml(path: str) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _parse_value(s: str) -> Any:
    """Parse a CLI override value with YAML semantics."""
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    if v is None and s.strip() not in ("", "null", "~", "None"):
        return s
    # yaml parses "- x" style block sequences; CLI/resolver args never mean that
    if isinstance(v, (list, dict)) and not s.strip().startswith(("[", "{")):
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


# a string, or a JSON float without a dot (``1e-15``), which YAML 1.1 reads as a string
_JSON_STRING_OR_BARE_EXP = re.compile(r'("(?:[^"\\]|\\.)*")|(?<![\d.])(-?\d+)(e[-+]\d+)')


def dump_config(path: str, cfg: Any) -> None:
    """Write ``cfg`` as JSON (a YAML document that :func:`load_config` reads back: each
    float with a dot, as YAML 1.1 wants)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = _JSON_STRING_OR_BARE_EXP.sub(lambda m: m[1] or f"{m[2]}.0{m[3]}",
                                         json.dumps(config_to_primitive(cfg), indent=2))
    with open(path, "w") as f:
        f.write(text + "\n")
