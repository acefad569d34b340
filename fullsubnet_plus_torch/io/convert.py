"""The weight bridge: the JAX package's parameter tree <-> the port's state_dict.

The port's modules are named after the reference's `state_dict` keys, so
its state_dict is exactly what the JAX package's `export_fullsubnet_plus`
and `export_fullsubnet` (io/torch_convert.py:274-301 there) emit. The only
layout change is a transpose of Linear and LSTM matrices (the JAX tree
stores them [in, out]); conv weights keep torch's [O, I/g, K] layout in
both.

`train_state_from_jax` and `jax_from_train_state` carry a whole training
state (parameters, Adam's moments and count, the step) the same way, so
both packages can start from the same mid-run state.

`key_table` lists every (JAX tree path, state_dict key, transposed) triple
of a model, in the reference's registration order: FullSubNet+ (TSSE
attention, TCN full-band models, 2-layer unidirectional LSTM sub-band
model) or the FullSubNet baseline (2-layer LSTM full-band and sub-band
models, each with its output Linear). Which one a tree or a state_dict
holds is read from its keys, or given as `model=`.
"""

from __future__ import annotations

import numpy as np
import torch

from fullsubnet_plus_torch.io.checkpoint import nested_from_flat

ATTENTIONS = ("channel_attention", "channel_attention_real", "channel_attention_imag")
FB_MODELS = ("fb_model", "fb_model_real", "fb_model_imag")
TCN_BLOCKS = 8


def _linear(path, key):
    return [(f"{path}/weight", f"{key}.weight", True), (f"{path}/bias", f"{key}.bias", False)]


def _plain(path, key, names=("weight", "bias")):
    return [(f"{path}/{n}", f"{key}.{n}", False) for n in names]


def _lstm_model(name: str, num_layers: int = 2):
    """A 2-layer (or `num_layers`) unidirectional LSTM sequence model and its
    output Linear (reference SequenceModel, sequence_model.py:5-96)."""
    table = []
    for layer in range(num_layers):
        src, dst = f"{name}/seq/layers/{layer}", f"{name}.sequence_model"
        table += [
            (f"{src}/w_ih", f"{dst}.weight_ih_l{layer}", True),
            (f"{src}/w_hh", f"{dst}.weight_hh_l{layer}", True),
            (f"{src}/b_ih", f"{dst}.bias_ih_l{layer}", False),
            (f"{src}/b_hh", f"{dst}.bias_hh_l{layer}", False),
        ]
    return table + _linear(f"{name}/fc_output_layer", f"{name}.fc_output_layer")


def key_table(sb_num_layers: int = 2, model: str = "fullsubnet_plus"):
    """[(jax "/"-path, state_dict key, transposed)] for FullSubNet+
    (`model="fullsubnet_plus"`) or FullSubNet (`model="fullsubnet"`)."""
    if model == "fullsubnet":
        return _lstm_model("fb_model") + _lstm_model("sb_model", sb_num_layers)
    if model != "fullsubnet_plus":
        raise ValueError(f"key_table: unknown model {model!r}")
    table = []
    for ca in ATTENTIONS:
        for jax_name, ref_name in (("small_conv", "smallConv1d.0"),
                                   ("middle_conv", "middleConv1d.0"),
                                   ("large_conv", "largeConv1d.0")):
            table += _plain(f"{ca}/{jax_name}", f"{ca}.{ref_name}")
        for fc in ("feature_concate_fc", "fc1", "fc2"):
            table += _linear(f"{ca}/{fc}", f"{ca}.{fc}")
    for fb in FB_MODELS:
        for i in range(TCN_BLOCKS):
            src, dst = f"{fb}/seq/blocks/{i}", f"{fb}.sequence_model.{i}"
            table += _plain(f"{src}/conv1x1", f"{dst}.conv1x1")
            table.append((f"{src}/prelu1", f"{dst}.prelu1.weight", False))
            table += _plain(f"{src}/norm1", f"{dst}.norm1")
            table += _plain(f"{src}/depthwise", f"{dst}.depthwise_conv")
            table.append((f"{src}/prelu2", f"{dst}.prelu2.weight", False))
            table += _plain(f"{src}/norm2", f"{dst}.norm2")
            table += _plain(f"{src}/sconv", f"{dst}.sconv")
        table += _linear(f"{fb}/fc_output_layer", f"{fb}.fc_output_layer")
    return table + _lstm_model("sb_model", sb_num_layers)


def model_of_tree(params) -> str:
    """"fullsubnet_plus" or "fullsubnet", from a JAX tree's top-level keys."""
    return "fullsubnet_plus" if "channel_attention" in params else "fullsubnet"


def model_of_state_dict(state_dict) -> str:
    """"fullsubnet_plus" or "fullsubnet", from a state_dict's keys."""
    plus = any(k.startswith("channel_attention.") for k in state_dict)
    return "fullsubnet_plus" if plus else "fullsubnet"


def _get(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def state_dict_from_jax(params, model: str | None = None) -> dict:
    """JAX FullSubNet+ or FullSubNet parameter tree (nested dicts/lists of
    arrays) -> reference-layout state_dict of float32 torch tensors.
    `model` ("fullsubnet_plus" or "fullsubnet") defaults to the tree's."""
    model = model or model_of_tree(params)
    out = {}
    for path, key, transposed in key_table(len(params["sb_model"]["seq"]["layers"]), model):
        value = np.array(_get(params, path), dtype=np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(value.T if transposed else value))
    return out


def jax_from_state_dict(state_dict, model: str | None = None) -> dict:
    """Inverse of `state_dict_from_jax`: reference-layout state_dict ->
    the JAX package's nested numpy parameter tree (for `.npz` checkpoints
    that either package loads). `model` defaults to the state_dict's."""
    model = model or model_of_state_dict(state_dict)
    layers = sum(1 for k in state_dict if k.startswith("sb_model.sequence_model.weight_ih_l"))
    flat = {}
    for path, key, transposed in key_table(layers, model):
        value = state_dict[key].detach().to("cpu", torch.float32).numpy()
        flat[path] = np.ascontiguousarray(value.T if transposed else value)
    return nested_from_flat(flat)


def train_state_from_jax(params, mu, nu, count, step, model: str | None = None) -> dict:
    """The JAX package's TrainState as numpy (parameter tree, Adam's `mu`
    and `nu` trees of the same shape, its `count` and the `step`) -> the
    dict that the port's `TrainState.load_state_dict` takes: the moments go
    through the same `key_table` and transposes as the parameters."""
    model = model or model_of_tree(params)
    return {"params": state_dict_from_jax(params, model),
            "mu": state_dict_from_jax(mu, model), "nu": state_dict_from_jax(nu, model),
            "count": int(count), "step": int(step)}


def jax_from_train_state(state: dict, model: str | None = None) -> dict:
    """Inverse of `train_state_from_jax`, from `TrainState.state_dict()`:
    {"params", "mu", "nu"} as the JAX package's nested numpy trees, "count"
    and "step" as ints."""
    model = model or model_of_state_dict(state["params"])
    return {**{k: jax_from_state_dict(state[k], model) for k in ("params", "mu", "nu")},
            "count": int(state["count"]), "step": int(state["step"])}
