"""YAML → nested-dataclass config loading.

The port's own copy of socioreasoner_tpu/configs/loader.py, kept as it is
there. It replaces the reference's Hydra + OmegaConf + dacite stack
(`examples/start_rlvr_socioseg_pipeline.py:20-31`): a minimal recursive
from_dict (dacite's role) plus yaml include handling via a `defaults:` list
(hydra's role, only the subset the reference uses).
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, Dict, Optional, Type, TypeVar, Union, get_args, get_origin

import yaml

T = TypeVar("T")


def _build(cls: Type, value: Any):
    if value is None:
        return None
    if isinstance(value, str) and value.startswith("${") and value.endswith("}"):
        return value  # ${...} interpolation resolved later by the config's __post_init__
    if dataclasses.is_dataclass(cls):
        return from_dict(cls, value)
    origin = get_origin(cls)
    if origin is Union:
        args = [a for a in get_args(cls) if a is not type(None)]
        if value is None:
            return None
        for a in args:
            try:
                return _build(a, value)
            except (TypeError, ValueError):
                continue
        return value
    if origin in (list, typing.List):
        (item_t,) = get_args(cls) or (Any,)
        return [_build(item_t, v) for v in value]
    if origin in (tuple, typing.Tuple):
        args = get_args(cls)
        item_t = args[0] if args else Any
        return tuple(_build(item_t, v) for v in value)
    if origin in (dict, typing.Dict):
        args = get_args(cls)
        vt = args[1] if len(args) == 2 else Any
        return {k: _build(vt, v) for k, v in value.items()}
    if cls in (int, float, str, bool):
        return cls(value)
    return value


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Recursive dataclass construction; unknown keys are collected into
    `extra_fields` if the dataclass has one, otherwise rejected."""
    if not isinstance(data, dict):
        raise TypeError(f"expected dict for {cls.__name__}, got {type(data)}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs, extra = {}, {}
    for key, value in data.items():
        if key in fields:
            ftype = fields[key].type
            if isinstance(ftype, str):
                hints = typing.get_type_hints(cls)
                ftype = hints.get(key, Any)
            kwargs[key] = _build(ftype, value)
        else:
            extra[key] = value
    if extra:
        if "extra_fields" in fields:
            kwargs["extra_fields"] = extra
        else:
            raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(extra)}")
    return cls(**kwargs)


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str) -> Dict[str, Any]:
    """Load a yaml file, resolving a hydra-style `defaults:` include list
    (relative paths, later entries and the file itself override earlier)."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    defaults = data.pop("defaults", None)
    merged: Dict[str, Any] = {}
    for entry in defaults or []:
        if entry in ("_self_",):
            merged = _deep_merge(merged, data)
            data = {}
            continue
        inc_path = os.path.join(os.path.dirname(path), f"{entry}.yaml")
        if os.path.exists(inc_path):
            merged = _deep_merge(merged, load_yaml(inc_path))
    return _deep_merge(merged, data)


def load_config(cls: Type[T], path: str, overrides: Optional[Dict[str, Any]] = None) -> T:
    data = load_yaml(path)
    if overrides:
        data = _deep_merge(data, overrides)
    return from_dict(cls, data)
