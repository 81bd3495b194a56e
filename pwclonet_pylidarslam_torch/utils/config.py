"""Config system: dataclass trees ← YAML files ← CLI ``a.b.c=value`` overrides.

The port's own copy of ``pwclonet_pylidarslam_tpu/utils/config.py``.

Replaces the reference's Hydra stack (``config/`` YAML tree + ConfigStore
registrations + ``ObjectLoaderEnum`` factories, SURVEY §2.8 "Config system")
with a dependency-free loader:

- any (frozen or mutable) dataclass tree can be built from a nested dict;
- YAML file + ``key.path=value`` override strings compose left to right;
- unknown keys raise with the valid field names (typo safety);
- the resolved config is dumped back to YAML in the run dir, with the git
  hash, like the reference persists (``odometry_runner.py:101-111``).
"""

from __future__ import annotations

import dataclasses
import subprocess
import typing
from typing import Any, Dict, List, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _resolve_hints(cls: type) -> Dict[str, Any]:
    """Field name → actual type objects. ``dataclasses.fields(...).type`` is a
    *string* under ``from __future__ import annotations``, so resolve through
    ``typing.get_type_hints`` (falls back to raw annotations if a module uses
    names that no longer import)."""
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def _unwrap_optional(tp: Any) -> Any:
    """``Optional[X]`` → ``X`` (so an ``Optional[dataclass]`` field defaulting
    to None can still be populated from YAML)."""
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _convert_scalar(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    if value.lower() in ("null", "none"):
        return None
    return value


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a dataclass tree from a nested dict (strict on unknown keys)."""
    if not dataclasses.is_dataclass(cls):
        return data  # leaf passthrough
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = _resolve_hints(cls)
    kwargs = {}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(
                f"{cls.__name__} has no field {key!r}; valid: {sorted(fields)}"
            )
        ftype = _unwrap_optional(hints.get(key, fields[key].type))
        if isinstance(value, dict):
            # prefer merging onto the field default (keeps sub-fields the
            # YAML doesn't mention); fall back to the annotated type for
            # Optional[dataclass] fields whose default is None
            default = fields[key].default
            if default is dataclasses.MISSING and (
                fields[key].default_factory is not dataclasses.MISSING  # type: ignore
            ):
                default = fields[key].default_factory()  # type: ignore
            if dataclasses.is_dataclass(default) and not isinstance(default, type):
                kwargs[key] = from_dict(type(default), _merge_nested(default, value))
            elif isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
                kwargs[key] = from_dict(ftype, value)
            else:
                kwargs[key] = value
        elif isinstance(value, list) and (ftype is tuple or get_origin(ftype) is tuple):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _merge_nested(default_obj, override: Dict[str, Any]) -> Dict[str, Any]:
    base = {}
    for f in dataclasses.fields(default_obj):
        v = getattr(default_obj, f.name)
        base[f.name] = v if not dataclasses.is_dataclass(v) else v
    out = dict(base)
    for k, v in override.items():
        if (
            k in out
            and dataclasses.is_dataclass(out[k])
            and isinstance(v, dict)
        ):
            out[k] = from_dict(type(out[k]), _merge_nested(out[k], v))
        else:
            out[k] = v
    # re-flatten dataclass values to stay constructible
    return {
        k: (v if not dataclasses.is_dataclass(v) or isinstance(v, type) else v)
        for k, v in out.items()
    }


def apply_overrides(data: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` strings onto a nested dict (Hydra-CLI style)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key.path=value")
        path, value = ov.split("=", 1)
        keys = path.split(".")
        node = data
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _convert_scalar(value)
    return data


def load_config(
    cls: Type[T],
    yaml_path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
) -> T:
    import yaml

    data: Dict[str, Any] = {}
    if yaml_path:
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
    if overrides:
        data = apply_overrides(data, overrides)
    return from_dict(cls, data)


def _preset_dir() -> str:
    """The shipped ``config/`` preset tree at the repo root (mirrors the
    reference's Hydra config groups)."""
    import os

    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "config",
    )


def resolve_preset(name: str) -> str:
    """``config=<x>`` resolution: an existing path wins; otherwise look up
    ``config/<x>.yaml`` (and ``config/<x>`` verbatim) in the shipped tree."""
    import os

    if os.path.exists(name):
        return name
    for cand in (
        os.path.join(_preset_dir(), name + ".yaml"),
        os.path.join(_preset_dir(), name),
    ):
        if os.path.exists(cand):
            return cand
    available = []
    if os.path.isdir(_preset_dir()):
        for root, _dirs, files in os.walk(_preset_dir()):
            rel = os.path.relpath(root, _preset_dir())
            available += [
                (f if rel == "." else f"{rel}/{f}").removesuffix(".yaml")
                for f in files
                if f.endswith(".yaml")
            ]
    raise FileNotFoundError(
        f"no config preset {name!r}; available: {sorted(available)}"
    )


def _deep_merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; ``b`` wins on conflicts."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def parse_cli(cls: Type[T], argv: List[str]) -> T:
    """Hydra-CLI-style parsing shared by the entry points: any number of
    ``config=<preset-or-path>`` YAML bases (deep-merged left to right, later
    wins) composed with ``a.b.c=value`` overrides (always win)."""
    import yaml

    data: Dict[str, Any] = {}
    for arg in argv:
        if arg.startswith("config="):
            with open(resolve_preset(arg.split("=", 1)[1])) as f:
                data = _deep_merge(data, yaml.safe_load(f) or {})
    data = apply_overrides(
        data, [a for a in argv if "=" in a and not a.startswith("config=")]
    )
    return from_dict(cls, data)


def dump_config(config: Any, path: str):
    """Persist the resolved config + git hash (ref odometry_runner.py:101-111)."""
    import yaml

    def clean(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return {f.name: clean(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if isinstance(obj, (list, tuple)):
            return [clean(x) for x in obj]
        if isinstance(obj, (int, float, str, bool)) or obj is None:
            return obj
        return repr(obj)

    payload = {"config": clean(config), "git_hash": git_hash()}
    with open(path, "w") as f:
        yaml.safe_dump(payload, f, sort_keys=False)


def git_hash() -> str:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5
            ).stdout.strip()
            or "unknown"
        )
    except Exception:
        return "unknown"
