"""Checkpoint files: the JAX package's `.npz` and the reference's `.tar`/`.pth`.

The JAX package stores a parameter tree as a flat `.npz` keyed by
"/"-joined tree paths plus a JSON `__meta__` entry
(fullsubnet_plus_tpu/io/checkpoint.py:45-111). `load_flat`,
`nested_from_flat` and `save_flat` here read and write that format with
numpy alone. The reference's torch checkpoints load through `torch.load`.

`CheckpointManager` keeps a training run's files in the JAX package's
layout and keys (its CheckpointManager, :114-180; reference
base_trainer.py:111-213), so a run of either package resumes in the other:
a train state is `params/<tree path>`, optax's Adam state under
`opt_state/1/0/` (`count`, `mu/<tree path>`, `nu/<tree path>`) and `step`,
with meta {"epoch", "best_score", "lr"}.
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


# optax.chain(clip_by_global_norm, adam) has the state (EmptyState,
# (ScaleByAdamState(count, mu, nu), EmptyState)): Adam's leaves sit under 1/0
ADAM_PREFIX = "opt_state/1/0"


def _subtree(flat: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def flat_from_train_state(state) -> dict:
    """A `TrainState` (train/step.py) -> the JAX package's flat keys."""
    from fullsubnet_plus_torch.io.convert import jax_from_train_state

    tree = jax_from_train_state(state.state_dict())
    flat = {f"params/{k}": v for k, v in flat_from_nested(tree["params"]).items()}
    for moment in ("mu", "nu"):
        flat.update({f"{ADAM_PREFIX}/{moment}/{k}": v
                     for k, v in flat_from_nested(tree[moment]).items()})
    flat[f"{ADAM_PREFIX}/count"] = np.asarray(tree["count"], np.int32)
    flat["step"] = np.asarray(tree["step"], np.int32)
    return flat


def train_state_from_flat(flat: dict) -> dict:
    """The JAX package's flat train-state keys -> the dict that
    `TrainState.load_state_dict` takes. Raises KeyError on a missing key."""
    from fullsubnet_plus_torch.io.convert import train_state_from_jax

    trees = [nested_from_flat(_subtree(flat, p))
             for p in ("params", f"{ADAM_PREFIX}/mu", f"{ADAM_PREFIX}/nu")]
    return train_state_from_jax(*trees, flat[f"{ADAM_PREFIX}/count"], flat["step"])


class CheckpointManager:
    """`checkpoints/` of a run: `latest_model.npz` (the whole train state),
    `model_{epoch:04d}.npz` (parameters) and `best_model.npz` (the whole
    state at the best validation score). Only the primary process writes."""

    def __init__(self, save_dir: str, is_primary: bool = True, lr: float | None = None):
        self.save_dir = os.path.abspath(os.path.expanduser(save_dir))
        self.ckpt_dir = os.path.join(self.save_dir, "checkpoints")
        self.is_primary = is_primary
        # in every file's meta, so an export to a torch .tar can set the
        # run's learning rate in Adam's param_groups
        self.lr = lr
        if is_primary:
            os.makedirs(self.ckpt_dir, exist_ok=True)

    @property
    def latest_path(self) -> str:
        return os.path.join(self.ckpt_dir, "latest_model.npz")

    def save(self, state, epoch: int, best_score: float, is_best: bool = False,
             latest_only: bool = False) -> None:
        """latest + the epoch's parameters (+ best) (base_trainer.py:159-200).
        `latest_only` leaves the epoch file alone: the preemption path labels
        its mid-epoch state with the previous epoch, whose file it must not
        overwrite."""
        if not self.is_primary:
            return
        meta = {"epoch": epoch, "best_score": float(best_score)}
        if self.lr is not None:
            meta["lr"] = float(self.lr)
        # "/"-joined keys pass through save_flat's flat_from_nested unchanged
        full = flat_from_train_state(state)
        save_flat(self.latest_path, full, meta)
        if not latest_only:
            params = {k: v for k, v in full.items() if k.startswith("params/")}
            save_flat(os.path.join(self.ckpt_dir, f"model_{epoch:04d}.npz"), params, meta)
        if is_best:
            save_flat(os.path.join(self.ckpt_dir, "best_model.npz"), full, meta)

    def resume(self, state):
        """Load latest_model.npz into `state` (in place) -> (state, epoch,
        best_score)."""
        flat, meta = load_flat(self.latest_path)
        state.load_state_dict(train_state_from_flat(flat))
        return state, int(meta["epoch"]), float(meta["best_score"])

    @staticmethod
    def preload_params(path: str, model) -> int:
        """Weights-only warm start (`-P`): every parameter the file holds
        (as `params/<path>` or a bare tree path) is loaded into `model`;
        the others keep their values. Returns the number loaded."""
        from fullsubnet_plus_torch.io.convert import key_table, layout_of_state_dict

        flat, _ = load_flat(path)
        flat = {k.removeprefix("params/"): v for k, v in flat.items()}
        found = {key: torch.from_numpy(np.ascontiguousarray(flat[p].T if transposed else flat[p]))
                 for p, key, transposed in key_table(**layout_of_state_dict(model.state_dict()))
                 if p in flat}
        model.load_state_dict(found, strict=False)
        return len(found)


def load_torch_checkpoint(path: str) -> tuple[dict, dict]:
    """A reference `.tar` ({"model", "optimizer", "epoch", "best_score"},
    base_trainer.py:159-190) -> (the dict that `TrainState.load_state_dict`
    takes, meta {"epoch", "best_score"} where present), torch Adam's
    per-parameter `exp_avg`, `exp_avg_sq` and `step` in its moments and
    count (fullsubnet_plus_tpu/io/checkpoint.py:218-282). The optimizer's
    state is indexed by the model's parameter order, which is the order of
    the state_dict's keys. Without optimizer state the moments are zero and
    the count 0; the step is the count."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = blob["model"] if "model" in blob else blob
    params = {k.removeprefix("module."): v.to(torch.float32) for k, v in state_dict.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    count = 0
    opt = blob.get("optimizer")
    if opt and opt.get("state"):
        indices = [i for group in opt["param_groups"] for i in group["params"]]
        if len(indices) != len(params):
            raise ValueError(f"the optimizer has {len(indices)} parameters, the model "
                             f"{len(params)}")
        counts = set()
        for key, index in zip(params, indices):
            entry = opt["state"][index]
            mu[key] = torch.as_tensor(entry["exp_avg"], dtype=torch.float32)
            nu[key] = torch.as_tensor(entry["exp_avg_sq"], dtype=torch.float32)
            counts.add(int(torch.as_tensor(entry["step"]).item()))
        if len(counts) != 1:
            raise ValueError(f"per-parameter Adam step counts differ: {sorted(counts)}")
        count = counts.pop()
    meta = {k: cast(blob[k]) for k, cast in (("epoch", int), ("best_score", float)) if k in blob}
    return {"params": params, "mu": mu, "nu": nu, "count": count, "step": count}, meta


# torch.cuda.amp.GradScaler().state_dict() defaults: the reference's resume
# calls scaler.load_state_dict(checkpoint["scaler"])
_SCALER_STATE = {"scale": 65536.0, "growth_factor": 2.0, "backoff_factor": 0.5,
                 "growth_interval": 2000, "_growth_tracker": 0}


def save_torch_checkpoint(path: str, params: dict, *, mu: dict | None = None,
                          nu: dict | None = None, count: int = 0, epoch: int = 0,
                          best_score: float = 0.0, lr: float = 1e-3) -> None:
    """Write a reference-format PyTorch checkpoint (the inverse of
    `load_torch_checkpoint`; fullsubnet_plus_tpu/io/checkpoint.py:283-362).

    `params` is a reference-layout state_dict. `.pth` gets it bare
    (base_trainer.py:192); `.tar` gets the reference trainer's artifact
    {"epoch", "best_score", "optimizer", "scaler", "model"}
    (base_trainer.py:159-190), whose optimizer state_dict carries Adam's
    moments `mu`, `nu` (state_dicts of the same keys) and step `count`
    indexed in the state_dict's order, which is the model's parameter
    order, so the reference's resume continues the run; without moments
    it is a fresh Adam's. `lr` fills the param_group."""
    model = {k: torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
             for k, v in params.items()}
    if path.endswith(".pth"):
        blob = model
    else:
        state = {}
        if mu is not None:
            state = {i: {"step": torch.tensor(float(count)),
                         "exp_avg": torch.as_tensor(mu[k]).to("cpu", torch.float32).contiguous(),
                         "exp_avg_sq": torch.as_tensor(nu[k]).to("cpu", torch.float32).contiguous()}
                     for i, k in enumerate(model)}
        group = {"lr": lr, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.0,
                 "amsgrad": False, "maximize": False, "foreach": None, "capturable": False,
                 "differentiable": False, "fused": None, "params": list(range(len(model)))}
        blob = {"epoch": epoch, "best_score": best_score,
                "optimizer": {"state": state, "param_groups": [group]},
                "scaler": dict(_SCALER_STATE), "model": model}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(blob, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
