"""Typed configuration (PyTorch counterpart of config/tools.py): the YAML
groups under configurations/ plus dotted command-line overrides, merged
into a dict and built into the port's dataclasses.

  - `load_config(config_dir, overrides)` reads config.yaml, resolves its
    `defaults:` group entries (group: name -> group/<name>.yaml, nested),
    deep-merges, then applies the overrides: `group=name` swaps a group's
    file, `a.b.c=value` sets a leaf (the value read as YAML);
  - `from_dict(cls, data)` builds nested dataclasses, dispatching fields
    typed as a union of dataclasses by their `name:` tag, casting Path,
    float, int and tuple fields, and raising on unknown keys.
"""

import dataclasses
import typing
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple, Union

import yaml


def _is_optional(tp) -> Tuple[bool, Any]:
    if typing.get_origin(tp) is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return True, args[0]
        return True, Union[tuple(args)]
    return False, tp


def from_dict(cls, data):
    """Recursively build `cls` (a dataclass, or a field type) from plain
    dicts and lists."""
    if data is None:
        return None
    _, cls = _is_optional(cls)
    origin = typing.get_origin(cls)
    if dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            raise TypeError(f"expected mapping for {cls.__name__}, got {type(data)}")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key not in fields:
                raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
            kwargs[key] = from_dict(fields[key].type, value)
        return cls(**kwargs)
    if origin is Union:
        # a name-tagged union of dataclasses
        if isinstance(data, dict) and "name" in data:
            for cand in typing.get_args(cls):
                if not dataclasses.is_dataclass(cand):
                    continue
                tag = next((f.default for f in dataclasses.fields(cand) if f.name == "name"),
                           None)
                if tag == data["name"]:
                    return from_dict(cand, data)
        raise TypeError(f"cannot dispatch union {cls} for {data!r}")
    if origin is list:
        (item_t,) = typing.get_args(cls) or (Any,)
        return [from_dict(item_t, v) for v in data]
    if origin is tuple:
        args = typing.get_args(cls)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(from_dict(args[0], v) for v in data)
        return tuple(from_dict(t, v) for t, v in zip(args, data))
    if origin is dict:
        _, vt = typing.get_args(cls) or (Any, Any)
        return {k: from_dict(vt, v) for k, v in data.items()}
    if cls is Path:
        return Path(data)
    if cls is float:
        return float(data)
    if cls is int and not isinstance(data, bool):
        return int(data)
    return data


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def apply_override(cfg: Dict, dotted: str, value) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def load_config(config_dir, overrides: Sequence[str] = ()) -> Dict:
    """config.yaml + its defaults groups + the overrides, as one dict."""
    config_dir = Path(config_dir)

    def read(path: Path) -> Dict:
        return yaml.safe_load(path.read_text(encoding="utf-8")) or {}

    def resolve(doc: Dict, base_dir: Path, group_choices: Dict[str, str]) -> Dict:
        defaults = doc.pop("defaults", [])
        merged: Dict = {}
        for entry in defaults:
            if isinstance(entry, str):
                if entry != "_self_":
                    merged = deep_merge(merged, resolve(read(base_dir / f"{entry}.yaml"),
                                                        base_dir, group_choices))
                continue
            for group, choice in entry.items():
                choice = group_choices.get(group, choice)
                group_file = base_dir / group / f"{choice}.yaml"
                sub = resolve(read(group_file), group_file.parent, group_choices)
                merged = deep_merge(merged, {group: sub})
        return deep_merge(merged, doc)

    group_choices, dotted = {}, []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if "." not in key and (config_dir / key).is_dir():
            group_choices[key] = val
        else:
            dotted.append((key, yaml.safe_load(val)))
    cfg = resolve(read(config_dir / "config.yaml"), config_dir, group_choices)
    for key, val in dotted:
        apply_override(cfg, key, val)
    return cfg
