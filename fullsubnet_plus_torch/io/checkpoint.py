"""Checkpoint files: the JAX package's `.npz` and the reference's `.tar`/`.pth`.

The JAX package stores a parameter tree as a flat `.npz` keyed by
"/"-joined tree paths plus a JSON `__meta__` entry
(fullsubnet_plus_tpu/io/checkpoint.py:45-111). `load_flat`,
`nested_from_flat` and `save_flat` here read and write that format with
numpy alone. The reference's torch checkpoints load through `torch.load`.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def load_flat(path: str):
    """`.npz` -> ({path: array}, meta)."""
    with np.load(path, allow_pickle=False) as data:
        flat, meta = {}, {}
        for key in data.files:
            if key == "__meta__":
                meta = json.loads(bytes(data[key]).decode())
            else:
                flat[key] = data[key]
    return flat, meta


def nested_from_flat(flat: dict):
    """{"a/0/b": arr} -> {"a": [{"b": arr}]}: all-digit keys become lists."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [rebuild(node[str(i)]) for i in range(len(keys))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def flat_from_nested(tree, prefix: str = "") -> dict:
    """Inverse of `nested_from_flat` (values as numpy arrays)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat_from_nested(v, f"{prefix}/{k}" if prefix else k))
    return out


def save_flat(path: str, tree, meta: dict | None = None) -> None:
    """Atomic write of a nested tree as the JAX package's `.npz` format."""
    payload = flat_from_nested(tree)
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_jax_params(path: str):
    """A JAX `.npz` checkpoint -> its nested numpy parameter tree (the
    "params/" subtree of a train state, or the whole file)."""
    flat, _ = load_flat(path)
    params = {k.removeprefix("params/"): v for k, v in flat.items()
              if k.startswith("params/")}
    return nested_from_flat(params or flat)


def load_torch_state_dict(path: str) -> dict:
    """A reference `.tar` ({"model": state_dict, ...}) or `.pth` (a raw
    state_dict) -> state_dict, with DataParallel's "module." prefix dropped
    (fullsubnet_plus_tpu/io/torch_convert.py:154)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    return {k.removeprefix("module."): v for k, v in state_dict.items()}
