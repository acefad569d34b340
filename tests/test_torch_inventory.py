"""The port's surface against the JAX package's, name by name, on the CPU.

For every module of fullsubnet_plus_tpu/ but ops/lstm_pallas.py (whose five
Pallas kernels are ported as K1-K5, PERF.md §6), each public top-level
function and class has a same-named top-level definition in the port's
counterpart module, or a row in COUNTERPARTS that names the port's
counterpart under another name (checked to exist) or says why there is
none. Both packages are read as source, so nothing is imported.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "fullsubnet_plus_tpu"
PORT_PKG = ROOT / "fullsubnet_plus_torch"
KERNELS = "ops/lstm_pallas.py"
RENAMED = {"io/torch_convert.py": "io/convert.py"}

# JAX module -> {public name: "[port module::]counterpart" (the JAX module's
# own counterpart when no module is named), or "- " and why there is none}.
# A JAX `*_init` / `*_apply` pair is one nn.Module of the port.
COUNTERPARTS = {
    "cli/verify_parity.py": {"our_enhance": "port_enhance"},
    "dsp/stft.py": {
        "frame_signal": "- internal to `stft`, which frames through torch.stft",
        "num_frames": "- torch.stft's output holds the frame count, 1 + L // hop",
    },
    "io/checkpoint.py": {
        "find_adam_state": "train/step.py::TrainState",  # holds Adam's moments, no optax chain
        "flatten_with_paths": "flat_from_nested",
        "restore_like": "train_state_from_flat",
        "save_pytree": "save_flat",
    },
    "io/torch_convert.py": {
        **{f"convert_{m}": "tree_from_table" for m in (
            "bigru", "bilstm", "channel_attention", "conv1d", "group_norm", "gru", "linear",
            "lstm", "se", "sequence_model", "tcn_block", "tsse")},
        **{f"export_{m}": "state_dict_from_table" for m in (
            "channel_attention", "conv1d", "group_norm", "linear", "lstm", "sequence_model",
            "tcn_block", "tsse")},
        "convert_fullsubnet": "jax_from_state_dict",
        "convert_fullsubnet_plus": "jax_from_state_dict",
        "export_fullsubnet": "state_dict_from_jax",
        "export_fullsubnet_plus": "state_dict_from_jax",
        "convert_adam_state": "io/checkpoint.py::load_torch_checkpoint",
        "export_adam_state": "io/checkpoint.py::save_torch_checkpoint",
    },
    "models/fullsubnet.py": {"init": "FullSubNet", "apply": "FullSubNet"},
    "models/fullsubnet_plus.py": {"init": "FullSubNetPlus", "apply": "FullSubNetPlus"},
    "nn/attention.py": {
        "cbam_init": "CBAM", "cbam_apply": "CBAM",
        "channel_attention_init": "channel_attention",
        "channel_attention_apply": "channel_attention",
        "conv_attention_block_init": "ConvAttentionBlock",
        "conv_attention_block_apply": "ConvAttentionBlock",
        "deep_tsse_init": "DeepTSSE", "deep_tsse_apply": "DeepTSSE",
        "eca_init": "ECA", "eca_apply": "ECA",
        "se_init": "SE", "se_apply": "SE",
        "self_attention_init": "SelfAttention", "self_attention_apply": "SelfAttention",
        "tsse_init": "TSSE", "tsse_apply": "TSSE",
        "tsse_attention_init": "TSSE_ATT", "tsse_attention_apply": "TSSE_ATT",
        "tsse_weight_apply": "TSSEWeight",
    },
    "nn/init.py": {"conv1d_init": "nn/layers.py::Conv1d", "linear_init": "nn/layers.py::Linear"},
    "nn/lstm.py": {name: "RNN" for name in (
        "lstm_init", "lstm_apply", "gru_init", "gru_apply", "bilstm_apply", "bigru_apply")},
    "nn/sequence.py": {
        "sequence_model_init": "SequenceModel", "sequence_model_apply": "SequenceModel",
        "complex_sequence_model_init": "ComplexSequenceModel",
        "complex_sequence_model_apply": "ComplexSequenceModel",
    },
    "nn/tcn.py": {
        "prelu": "nn/layers.py::PReLU",
        "tcn_block_init": "TCNBlock", "tcn_block_apply": "TCNBlock",
        "tcn_stack_init": "tcn_stack", "tcn_stack_apply": "tcn_stack",
        "causal_conv_block_init": "CausalConvBlock",
        "causal_conv_block_apply": "CausalConvBlock",
        "causal_trans_conv_block_init": "CausalTransConvBlock",
        "causal_trans_conv_block_apply": "CausalTransConvBlock",
    },
    "parallel/mesh.py": {
        "freq_sharding": "ops/lstm2.py::fold_split",
        "globalize_batch": "row_offset",  # the rows stay local; the offset orders them
    },
    "utils/misc.py": {
        "enable_compilation_cache": "- JAX-only: XLA's persistent compilation cache; the "
                                    "port's kernels are built by nvcc, once a source digest "
                                    "(ops/nvcc.py)",
    },
}


def _public(path: Path, bindings: bool = False) -> set:
    """The public top-level functions and classes of a module's source; with
    `bindings`, its other top-level names too (assignments, `init = ...`)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif bindings and isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def _modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                  if str(p.relative_to(JAX_PKG)) != KERNELS)


def test_every_jax_module_has_a_port_counterpart():
    missing = [m for m in _modules() if not (PORT_PKG / RENAMED.get(m, m)).exists()]
    assert not missing, f"JAX modules without a port counterpart: {missing}"
    assert len(_modules()) > 40


@pytest.mark.parametrize("module", _modules())
def test_every_public_jax_name_has_a_counterpart(module):
    port_module = RENAMED.get(module, module)
    port_names = _public(PORT_PKG / port_module, bindings=True)
    table = COUNTERPARTS.get(module, {})
    jax_names = _public(JAX_PKG / module)
    unmatched = sorted(n for n in jax_names if n not in port_names and n not in table)
    assert not unmatched, (f"{module}: public JAX names with no same-named counterpart in "
                           f"fullsubnet_plus_torch/{port_module} and no row in COUNTERPARTS: "
                           f"{unmatched}")
    stale = sorted(n for n in table if n not in jax_names or n in port_names)
    assert not stale, f"{module}: rows of COUNTERPARTS that no longer apply: {stale}"
    for name, target in table.items():
        if target.startswith("- "):
            continue
        where, _, counterpart = target.rpartition("::")
        assert counterpart in _public(PORT_PKG / (where or port_module), bindings=True), (
            f"{module}::{name} names fullsubnet_plus_torch/{where or port_module}::"
            f"{counterpart}, which does not exist")


def test_the_table_names_only_jax_modules():
    assert set(COUNTERPARTS) <= set(_modules())
