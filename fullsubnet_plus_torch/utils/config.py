"""TOML config loading, merging and writing (the reference's section shape).

Counterpart of fullsubnet_plus_tpu/utils/config.py: the same files parse
with the standard library's tomllib; `merge_config` is the reference's deep
merge (audio_zen/utils.py:127-180) and `dump_config` writes the resolved
config beside the checkpoints (base_trainer.py:106-107).
"""

from __future__ import annotations

import copy
import os
import tomllib


def load_config(path: str) -> dict:
    with open(os.path.abspath(os.path.expanduser(path)), "rb") as f:
        return tomllib.load(f)


def merge_config(base: dict, override: dict) -> dict:
    """Recursive dict merge; `override` wins."""
    result = copy.deepcopy(base)
    for key, value in override.items():
        if key in result and isinstance(result[key], dict) and isinstance(value, dict):
            result[key] = merge_config(result[key], value)
        else:
            result[key] = copy.deepcopy(value)
    return result


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return repr(v)


def dump_config(config: dict, path: str) -> None:
    """Write `config` as TOML (the standard library has no writer): each
    table's scalars under its header, then its subtables."""
    lines = []

    def walk(table: dict, prefix: str):
        scalars = {k: v for k, v in table.items() if not isinstance(v, dict)}
        subtables = {k: v for k, v in table.items() if isinstance(v, dict)}
        if prefix and (scalars or not subtables):
            lines.append(f"[{prefix}]")
        lines.extend(f"{k} = {_toml_value(v)}" for k, v in scalars.items())
        if scalars:
            lines.append("")
        for k, v in subtables.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(config, "")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
