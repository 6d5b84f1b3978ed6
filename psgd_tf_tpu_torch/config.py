"""Config system: JSON-file + key=value overrides onto workload signatures.

Counterpart of `psgd_tf_tpu/config.py`, with its rules: every workload's
`run(**kwargs)` signature is its config schema; `load` merges a JSON file
and CLI-style `key=value` overrides against that signature, coercing each
override to the type of the parameter's default (a NamedTuple default takes
a JSON object of its fields), and rejects unknown keys so typos fail
loudly.
"""
from __future__ import annotations

import inspect
import json
from typing import Any, Callable, Mapping, Sequence


def schema(run_fn: Callable) -> dict[str, Any]:
    """Parameter-name -> default for a workload's run()."""
    out = {}
    for name, p in inspect.signature(run_fn).parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        out[name] = None if p.default is p.empty else p.default
    return out


def _coerce(value: str, default: Any) -> Any:
    """Coerce a CLI string against the default's type."""
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, str):
        return value
    if default is None:
        # best effort: JSON literal, else raw string
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            return value
    # structured default (NamedTuple / tuple / list / dict): parse JSON and
    # rebuild the default's type — `type(default)(raw_string)` would mangle
    parsed = json.loads(value)
    if hasattr(default, "_fields"):  # NamedTuple
        if not isinstance(parsed, Mapping):
            raise ValueError(
                f"expected a JSON object for {type(default).__name__}, got {value!r}"
            )
        return default._replace(**parsed)
    if isinstance(default, (list, tuple)):
        if not isinstance(parsed, list):
            raise ValueError(f"expected a JSON array, got {value!r}")
        return type(default)(parsed)
    if isinstance(default, Mapping):
        if not isinstance(parsed, Mapping):
            raise ValueError(f"expected a JSON object, got {value!r}")
        return dict(parsed)
    raise ValueError(
        f"cannot coerce {value!r} onto default of type {type(default).__name__}"
    )


def load(
    run_fn: Callable,
    config_path: str | None = None,
    overrides: Sequence[str] = (),
) -> dict[str, Any]:
    """Build kwargs for `run_fn` from a JSON file + key=value overrides."""
    sig = schema(run_fn)
    cfg: dict[str, Any] = {}

    if config_path:
        with open(config_path) as f:
            file_cfg = json.load(f)
        if not isinstance(file_cfg, Mapping):
            raise ValueError(f"{config_path} must hold a JSON object")
        cfg.update(file_cfg)

    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, value = item.split("=", 1)
        cfg[key] = _coerce(value, sig.get(key))

    unknown = set(cfg) - set(sig)
    if unknown:
        raise ValueError(
            f"unknown config keys {sorted(unknown)}; valid: {sorted(sig)}"
        )
    return cfg
