"""The weight bridge: the JAX package's parameter tree <-> the port's state_dict.

The port's modules are named after the reference's `state_dict` keys, so
its state_dict is what the JAX package's `export_fullsubnet_plus` and
`export_fullsubnet` (io/torch_convert.py:274-301 there) emit. The only
layout change is a transpose of Linear and recurrent matrices (the JAX tree
stores them [in, out]); conv weights keep torch's [O, I/g, K] layout in
both.

`train_state_from_jax` and `jax_from_train_state` carry a whole training
state (parameters, Adam's moments and count, the step) the same way, so
both packages can start from the same mid-run state.

`key_table` lists every (JAX tree path, state_dict key, transposed) triple
of a model variant, in the reference's registration order. A variant's
table depends on its layout: the model (FullSubNet+ or FullSubNet), the
channel attention's parameter family (TSSE, SE and CBAM alike, ECA,
DeepTSSE, TSSE_ATT; io/torch_convert.py:118-146 and :253-272 there), the
sub-band sequence model (a recurrent model, LSTM and GRU alike, or a TCN;
:41-116 and :202-251) with its layers and direction. `layout_of_config`,
`layout_of_tree` and `layout_of_state_dict` read it from a model config, a
tree or a state_dict. TSSE_ATT's JAX tree holds one non-array leaf a
self-attention, "d_k": its width (JAX nn/attention.py:251); the state_dict
has none (the port keeps d_k a module constant), so the bridge skips it on
the way in and writes it back on the way out.
"""

from __future__ import annotations

import numpy as np
import torch

from fullsubnet_plus_torch.io.checkpoint import nested_from_flat

ATTENTIONS = ("channel_attention", "channel_attention_real", "channel_attention_imag")
FB_MODELS = ("fb_model", "fb_model_real", "fb_model_imag")
TCN_BLOCKS = 8
SCALES = (("small", "smallConv1d"), ("middle", "middleConv1d"), ("large", "largeConv1d"))
RNN_TENSORS = (("w_ih", "weight_ih", True), ("w_hh", "weight_hh", True),
               ("b_ih", "bias_ih", False), ("b_hh", "bias_hh", False))
ATTENTION_LINEARS = ("q_linear", "k_linear", "v_linear", "out")


def _linear(path, key):
    return [(f"{path}/weight", f"{key}.weight", True), (f"{path}/bias", f"{key}.bias", False)]


def _plain(path, key, names=("weight", "bias")):
    return [(f"{path}/{n}", f"{key}.{n}", False) for n in names]


def _rnn(src: str, dst: str, num_layers: int, bidirectional: bool):
    """A torch.nn.LSTM / GRU: per layer the forward direction, then (with
    `bidirectional`) the `_reverse` one, whose JAX trees are "fwd" and "bwd"."""
    table = []
    for layer in range(num_layers):
        for sfx, branch in ((("", "fwd"), ("_reverse", "bwd")) if bidirectional
                            else (("", None),)):
            path = f"{src}/{branch}/layers/{layer}" if branch else f"{src}/layers/{layer}"
            table += [(f"{path}/{j}", f"{dst}.{t}_l{layer}{sfx}", tr) for j, t, tr in RNN_TENSORS]
    return table


def _tcn(src: str, dst: str):
    table = []
    for i in range(TCN_BLOCKS):
        s, d = f"{src}/blocks/{i}", f"{dst}.{i}"
        table += _plain(f"{s}/conv1x1", f"{d}.conv1x1")
        table.append((f"{s}/prelu1", f"{d}.prelu1.weight", False))
        table += _plain(f"{s}/norm1", f"{d}.norm1")
        table += _plain(f"{s}/depthwise", f"{d}.depthwise_conv")
        table.append((f"{s}/prelu2", f"{d}.prelu2.weight", False))
        table += _plain(f"{s}/norm2", f"{d}.norm2")
        table += _plain(f"{s}/sconv", f"{d}.sconv")
    return table


def sequence_model_table(name: str, kind: str, num_layers: int = 2, bidirectional: bool = False):
    """A reference SequenceModel (sequence_model.py:5-96) and its output
    Linear: a TCN ("TCN", "TCN-subband") or a recurrent model."""
    src, dst = f"{name}/seq", f"{name}.sequence_model"
    seq = (_tcn(src, dst) if kind.startswith("TCN")
           else _rnn(src, dst, num_layers, bidirectional))
    return seq + _linear(f"{name}/fc_output_layer", f"{name}.fc_output_layer")


def attention_table(ca: str, kind: str):
    """A channel attention's parameters (reference attention_model.py)."""
    table = []
    if kind == "ECA":
        return [(f"{ca}/conv/weight", f"{ca}.conv.weight", False)]
    if kind in ("TSSE", "DeepTSSE", "TSSE_ATT"):
        for jax_name, ref_name in SCALES:
            src, dst = f"{ca}/{jax_name}", f"{ca}.{ref_name}"
            if kind == "TSSE":
                table += _plain(f"{src}_conv", f"{dst}.0")
            elif kind == "DeepTSSE":
                table += _plain(f"{src}_conv1", f"{dst}.0") + _plain(f"{src}_conv2", f"{dst}.2")
            else:
                table += _plain(f"{src}_conv/conv1d", f"{dst}.conv1d")
                for fc in ATTENTION_LINEARS:
                    table += _linear(f"{src}_conv/attention/{fc}", f"{dst}.attention.{fc}")
        table += _linear(f"{ca}/feature_concate_fc", f"{ca}.feature_concate_fc")
    elif kind not in ("SE", "CBAM"):
        raise NotImplementedError(f"Not implemented channel attention model {kind}")
    return table + _linear(f"{ca}/fc1", f"{ca}.fc1") + _linear(f"{ca}/fc2", f"{ca}.fc2")


def causal_block_table(name: str):
    """A CausalConvBlock or CausalTransConvBlock of nn/tcn.py (JAX
    nn/tcn.py:204-268): the conv's weight and bias, BatchNorm2d's weight,
    bias and running statistics. The two blocks have the same rows: the
    transposed weight keeps torch's [I, O, kf, kt] layout in both trees."""
    return _plain(f"{name}/conv", f"{name}.conv") + _plain(
        f"{name}/norm", f"{name}.norm", names=("weight", "bias", "running_mean", "running_var"))


def key_table(sb_num_layers: int = 2, model: str = "fullsubnet_plus", attention: str = "TSSE",
              sequence_model: str = "LSTM", bidirectional: bool = False):
    """[(jax "/"-path, state_dict key, transposed)] for a FullSubNet+
    (`model="fullsubnet_plus"`) or FullSubNet (`model="fullsubnet"`) layout:
    its `attention`, its sub-band `sequence_model` ("LSTM", "GRU", "TCN";
    FullSubNet's full-band model is of the same kind) with `sb_num_layers`
    layers and `bidirectional`."""
    sub_band = sequence_model_table("sb_model", sequence_model, sb_num_layers, bidirectional)
    if model == "fullsubnet":
        return sequence_model_table("fb_model", sequence_model) + sub_band
    if model != "fullsubnet_plus":
        raise ValueError(f"key_table: unknown model {model!r}")
    table = []
    for ca in ATTENTIONS:
        table += attention_table(ca, attention)
    for fb in FB_MODELS:
        table += sequence_model_table(fb, "TCN")
    return table + sub_band


def layout_of_config(config) -> dict:
    """`key_table`'s arguments for a FullSubNetPlusConfig or FullSubNetConfig."""
    plus = hasattr(config, "channel_attention_model")
    return {"model": "fullsubnet_plus" if plus else "fullsubnet",
            "attention": config.channel_attention_model if plus else "TSSE",
            "sequence_model": config.sequence_model, "sb_num_layers": 2,
            "bidirectional": False}


def _rnn_layout(seq) -> tuple:
    """(sequence_model, layers, bidirectional) of a JAX sequence tree."""
    if "blocks" in seq:
        return "TCN", 2, False
    if "fwd" in seq:
        return "LSTM", len(seq["fwd"]["layers"]), True
    return "LSTM", len(seq["layers"]), False


def layout_of_tree(params) -> dict:
    """`key_table`'s arguments read from a JAX tree's structure (LSTM stands
    for any recurrent model, SE for SE and CBAM: their keys are the same)."""
    kind, layers, bidirectional = _rnn_layout(params["sb_model"]["seq"])
    layout = {"model": "fullsubnet_plus" if "channel_attention" in params else "fullsubnet",
              "attention": "TSSE", "sequence_model": kind, "sb_num_layers": layers,
              "bidirectional": bidirectional}
    if layout["model"] == "fullsubnet_plus":
        ca = params["channel_attention"]
        layout["attention"] = ("ECA" if "conv" in ca else "DeepTSSE" if "small_conv1" in ca
                               else "SE" if "small_conv" not in ca
                               else "TSSE_ATT" if "conv1d" in ca["small_conv"] else "TSSE")
    return layout


def layout_of_state_dict(state_dict) -> dict:
    """`key_table`'s arguments read from a state_dict's keys."""
    keys = set(state_dict)
    plus = "channel_attention.fc1.weight" in keys or "channel_attention.conv.weight" in keys
    bidirectional = "sb_model.sequence_model.weight_ih_l0_reverse" in keys
    layers = sum(1 for k in keys if k.startswith("sb_model.sequence_model.weight_ih_l")
                 and not k.endswith("_reverse"))
    layout = {"model": "fullsubnet_plus" if plus else "fullsubnet", "attention": "TSSE",
              "sequence_model": "LSTM" if layers else "TCN", "sb_num_layers": layers or 2,
              "bidirectional": bidirectional}
    if plus:
        layout["attention"] = (
            "ECA" if "channel_attention.conv.weight" in keys
            else "TSSE_ATT" if "channel_attention.smallConv1d.conv1d.weight" in keys
            else "DeepTSSE" if "channel_attention.smallConv1d.2.weight" in keys
            else "TSSE" if "channel_attention.smallConv1d.0.weight" in keys else "SE")
    return layout


def _get(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def state_dict_from_jax(params, model: str | None = None) -> dict:
    """JAX FullSubNet+ or FullSubNet parameter tree (nested dicts/lists of
    arrays) of any variant -> reference-layout state_dict of float32 torch
    tensors (TSSE_ATT's "d_k" leaves skipped). The layout is the tree's;
    `model` ("fullsubnet_plus" or "fullsubnet") may name the model."""
    layout = layout_of_tree(params) | ({"model": model} if model else {})
    return state_dict_from_table(params, key_table(**layout))


def state_dict_from_table(tree, table) -> dict:
    """The state_dict entries of `table`'s rows (a key table, or the rows of
    `attention_table` / `sequence_model_table` for one module), read from a
    JAX tree as float32 torch tensors."""
    out = {}
    for path, key, transposed in table:
        value = np.array(_get(tree, path), dtype=np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(value.T if transposed else value))
    return out


def jax_from_state_dict(state_dict, model: str | None = None, constants: bool = True) -> dict:
    """Inverse of `state_dict_from_jax`: reference-layout state_dict ->
    the JAX package's nested numpy parameter tree (for `.npz` checkpoints
    that either package loads). The layout is the state_dict's; `model` may
    name the model. `constants` writes TSSE_ATT's "d_k" leaves (each
    self-attention's width), which a parameter tree holds and an optimizer
    moment's does not."""
    layout = layout_of_state_dict(state_dict) | ({"model": model} if model else {})
    return tree_from_table(state_dict, key_table(**layout), constants)


def tree_from_table(state_dict, table, constants: bool = True) -> dict:
    """The nested numpy JAX tree of `table`'s rows, read from a state_dict
    (the inverse of `state_dict_from_table`); with `constants`, each
    self-attention's "d_k" leaf too."""
    flat = {}
    for path, key, transposed in table:
        value = state_dict[key].detach().to("cpu", torch.float32).numpy()
        flat[path] = np.ascontiguousarray(value.T if transposed else value)
        if constants and path.endswith("/attention/q_linear/weight"):
            flat[path.replace("q_linear/weight", "d_k")] = int(value.shape[1])
    return nested_from_flat(flat)


def train_state_from_jax(params, mu, nu, count, step, model: str | None = None) -> dict:
    """The JAX package's TrainState as numpy (parameter tree, Adam's `mu`
    and `nu` trees of the same shape, its `count` and the `step`) -> the
    dict that the port's `TrainState.load_state_dict` takes: the moments go
    through the same `key_table` and transposes as the parameters."""
    return {"params": state_dict_from_jax(params, model),
            "mu": state_dict_from_jax(mu, model), "nu": state_dict_from_jax(nu, model),
            "count": int(count), "step": int(step)}


def jax_from_train_state(state: dict, model: str | None = None) -> dict:
    """Inverse of `train_state_from_jax`, from `TrainState.state_dict()`:
    {"params", "mu", "nu"} as the JAX package's nested numpy trees, "count"
    and "step" as ints."""
    return {**{k: jax_from_state_dict(state[k], model, constants=k == "params")
               for k in ("params", "mu", "nu")},
            "count": int(state["count"]), "step": int(state["step"])}
