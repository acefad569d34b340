"""TOML config loading (the reference's section shape).

Counterpart of `load_config` in fullsubnet_plus_tpu/utils/config.py: the
same files parse with the standard library's tomllib.
"""

from __future__ import annotations

import os
import tomllib


def load_config(path: str) -> dict:
    with open(os.path.abspath(os.path.expanduser(path)), "rb") as f:
        return tomllib.load(f)
