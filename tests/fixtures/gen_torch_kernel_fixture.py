"""Generate the committed kernel fixture (tests/fixtures/torch_kernel_fixture.npz):
the outputs of the JAX package's fused-LSTM kernels, run in interpret mode
on the CPU as the JAX package's own tests run them, at small ragged shapes
(N not a multiple of 16 or 32, odd T): FullSubNet+'s sub-band shape (D 34,
H 384, O 2) at T 7-9 and at the serving length T 255, a narrow one (H 64),
and FullSubNet's full-band shape (D 257, H 512, O 257).

  * K1, `stacked_lstm2(..., interpret=True)` (fullsubnet_plus_tpu/ops/
    lstm_pallas.py:210), float32 and bfloat16: y [N, T, O];
  * K5, `stacked_lstm2_quantized(..., interpret=True)` (:1084) on the
    bfloat16 weights with their int8 preparation: y;
  * K2-K4, `stacked_lstm2_train(..., interpret=True)` (:598) under
    `jax.value_and_grad` of sum(y * dy), in both `FUSED_WGRAD` forms, float32
    and bfloat16: y, the value, dx and the ten parameters' gradients in
    torch.nn.LSTM's order and layout (weight_ih_l0, weight_hh_l0, bias_ih_l0,
    bias_hh_l0, the same of layer 1, the Linear's weight and bias), also at
    the full-band shape (the `_fb` training cases), where each weight
    gradient G [out, in] is stored as its product with a seeded probe,
    G^T P [in, PROBE_COLS] (P [out, PROBE_COLS]: over the 4H gate columns
    of the kernels' [in, 4H] layout, and the Linear's O outputs), under
    `d_<name>@probe`: whole, they would add about 15 MB a case.

Only outputs are stored (the full-band cases' weights alone would add about
15 MB): `case_arrays` rebuilds the weights and the inputs from the case's
seed with numpy alone (every weight uniform in +-1/sqrt(H), drawn in
a fixed order; x uniform in [0, 2), positive with mean 1 as after the
Laplace norm; dy standard normal), so a test without JAX can make the same
operands: `port_operands` builds them for fullsubnet_plus_torch, and
`load_fixture` reads the committed outputs. bfloat16 cases round the float32
arrays to bfloat16 (nearest even) on both sides. This module imports JAX
only inside `run_case`, and torch only inside `port_operands`, so the card's
tests and chip_smoke.py load it by path where JAX is absent.

Run from the repo root (CPU, a few minutes: the T 255 and the full-band
training cases loop in interpret mode):

    JAX_PLATFORMS=cpu python tests/fixtures/gen_torch_kernel_fixture.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_kernel_fixture.npz")

# name: kernel, N, T, D, H, O, dtype, seed, FUSED_WGRAD (training cases)
CASES = {
    "k1_float32_h384": ("k1", 37, 9, 34, 384, 2, "float32", 1, None),
    "k1_bfloat16_h384": ("k1", 37, 9, 34, 384, 2, "bfloat16", 1, None),
    "k1_float32_h64": ("k1", 50, 7, 34, 64, 3, "float32", 2, None),
    "k1_bfloat16_h64": ("k1", 50, 7, 34, 64, 3, "bfloat16", 2, None),
    "k5_h384": ("k5", 37, 9, 34, 384, 2, "bfloat16", 3, None),
    "k5_h64": ("k5", 50, 7, 34, 64, 3, "bfloat16", 4, None),
    "train_float32_fused": ("train", 50, 7, 34, 64, 2, "float32", 5, True),
    "train_float32_dgates": ("train", 50, 7, 34, 64, 2, "float32", 5, False),
    "train_bfloat16_fused": ("train", 50, 7, 34, 64, 2, "bfloat16", 6, True),
    "train_bfloat16_dgates": ("train", 50, 7, 34, 64, 2, "bfloat16", 6, False),
    # serving length: T 255, as the serving fold, on a small fold
    "k1_float32_t255": ("k1", 5, 255, 34, 384, 2, "float32", 7, None),
    "k1_bfloat16_t255": ("k1", 5, 255, 34, 384, 2, "bfloat16", 7, None),
    "k5_t255": ("k5", 5, 255, 34, 384, 2, "bfloat16", 8, None),
    # FullSubNet's full-band LSTM (D 257, H 512, O 257) on a small fold
    "k1_float32_fb": ("k1", 7, 9, 257, 512, 257, "float32", 9, None),
    "k1_bfloat16_fb": ("k1", 7, 9, 257, 512, 257, "bfloat16", 9, None),
    "k5_fb": ("k5", 7, 9, 257, 512, 257, "bfloat16", 10, None),
    # FullSubNet's training step: K2-K4 at the full-band shape, weight
    # gradients probed (`stored`)
    "train_float32_fused_fb": ("train", 7, 9, 257, 512, 257, "float32", 11, True),
    "train_float32_dgates_fb": ("train", 7, 9, 257, 512, 257, "float32", 11, False),
    "train_bfloat16_fused_fb": ("train", 7, 9, 257, 512, 257, "bfloat16", 12, True),
    "train_bfloat16_dgates_fb": ("train", 7, 9, 257, 512, 257, "bfloat16", 12, False),
}
PROBE_COLS = 8  # columns of the probe a full-band case's weight gradients are stored through
GRAD_NAMES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0", "weight_ih_l1",
              "weight_hh_l1", "bias_ih_l1", "bias_hh_l1", "fc_weight", "fc_bias")


def case_arrays(name: str):
    """(params, fc, x, dy) of a case, float32 numpy: params and fc in the JAX
    package's layout ({"layers": [{w_ih [in, 4H], w_hh [H, 4H], b_ih, b_hh}
    x 2]}, {"weight": [H, O], "bias": [O]}), x [N, D, T], dy [N, T, O]."""
    _, n, t, d, h, o, _, seed, _ = CASES[name]
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(h)

    def uniform(*shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    layers = [{"w_ih": uniform(d_in, 4 * h), "w_hh": uniform(h, 4 * h),
               "b_ih": uniform(4 * h), "b_hh": uniform(4 * h)} for d_in in (d, h)]
    fc = {"weight": uniform(h, o), "bias": uniform(o)}
    x = rng.uniform(0.0, 2.0, (n, d, t)).astype(np.float32)
    dy = rng.standard_normal((n, t, o)).astype(np.float32)
    return {"layers": layers}, fc, x, dy


def probed(name: str) -> bool:
    """Whether a training case stores its weight gradients through probes."""
    return name.endswith("_fb") and CASES[name][0] == "train"


def stored(name: str, arrays: dict) -> dict:
    """The keys and arrays a case keeps: as computed, except that a probed
    case's weight gradient d_<w> [out, in] becomes d_<w>@probe = d_<w>^T P
    [in, PROBE_COLS], P standard normal over sqrt(out) from the case's seed
    (float64 products, stored float32)."""
    if not probed(name):
        return arrays
    rng = np.random.default_rng(1000 + CASES[name][7])
    out = {}
    for key, value in arrays.items():
        if key.startswith("d_") and "weight" in key:
            probe = rng.standard_normal((value.shape[0], PROBE_COLS)) / np.sqrt(value.shape[0])
            out[f"{key}@probe"] = (value.astype(np.float64).T @ probe).astype(np.float32)
        else:
            out[key] = value
    return out


def torch_layout(params, fc) -> list:
    """torch.nn.LSTM's eight tensors and the Linear's two (GRAD_NAMES order),
    as float32 numpy."""
    out = []
    for layer in params["layers"]:
        out += [layer["w_ih"].T, layer["w_hh"].T, layer["b_ih"], layer["b_hh"]]
    out += [fc["weight"].T, fc["bias"]]
    return [np.ascontiguousarray(a, np.float32) for a in out]


def port_operands(name: str, device="cpu"):
    """(x [N, D, T] in the case's dtype, dy [N, T, O] float32, the port's
    LSTM2 and Linear holding the case's weights in its dtype) on `device`."""
    import torch

    from fullsubnet_plus_torch.nn.layers import Linear
    from fullsubnet_plus_torch.nn.lstm import LSTM2

    _, n, t, d, h, o, dtype, _, _ = CASES[name]
    params, fc, x, dy = case_arrays(name)
    tensors = [torch.from_numpy(a) for a in torch_layout(params, fc)]
    lstm, linear = LSTM2(d, h), Linear(h, o)
    lstm.load_state_dict(dict(zip(GRAD_NAMES[:8], tensors[:8])))
    linear.load_state_dict({"weight": tensors[8], "bias": tensors[9]})
    dt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(device, dt), torch.from_numpy(dy).to(device),
            lstm.to(device, dt), linear.to(device, dt))


def port_run(name: str, device="cpu") -> dict:
    """The case through fullsubnet_plus_torch's entry points on `device`
    (the plain versions on the CPU, the kernels on a card), keyed as the
    fixture, float32 on the CPU: K1 `lstm2_fc`, K5 `lstm2_int8_fc`, the
    training cases `lstm2_fc_train` and autograd with `FUSED_WGRAD` set."""
    import torch

    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8, lstm2_train

    kernel, *_, fused = CASES[name]
    x, dy, lstm, linear = port_operands(name, device)
    if kernel == "k1":
        return {"y": lstm2.lstm2_fc(x, lstm.packed(linear)).float().cpu().numpy()}
    if kernel == "k5":
        y = lstm2_int8.lstm2_int8_fc(x, lstm.prepare_int8(linear))
        return {"y": y.float().cpu().numpy()}
    before = lstm2_train.FUSED_WGRAD
    lstm2_train.FUSED_WGRAD = fused
    try:
        xg = x.detach().requires_grad_()
        tensors = [p.requires_grad_() for p in lstm.tensors(linear)]
        with torch.enable_grad():
            y = lstm2_train.lstm2_fc_train(xg, *tensors)
            value = (y.float() * dy).sum()
            grads = torch.autograd.grad(value, (xg, *tensors))
    finally:
        lstm2_train.FUSED_WGRAD = before

    def f32(a):
        return a.detach().float().cpu().numpy()

    return stored(name, {"y": f32(y), "value": f32(value), "dx": f32(grads[0]),
                         **{f"d_{g}": f32(a) for g, a in zip(GRAD_NAMES, grads[1:])}})


def load_fixture(path: str = FIXTURE) -> dict:
    """{case: {key: array}} from the committed file; raises if it was made
    for other cases than CASES."""
    with np.load(path) as data:
        if str(data["cases"]) != json.dumps(CASES):
            raise ValueError(f"{path} holds other cases than CASES: regenerate it")
        out = {name: {} for name in CASES}
        for key in data.files:
            if key != "cases":
                name, field = key.split("/")
                out[name][field] = data[key]
    return out


def run_case(name: str) -> dict:
    """The JAX kernels' outputs of one case (float32 numpy), keyed as stored."""
    import jax
    import jax.numpy as jnp

    from fullsubnet_plus_tpu.ops import lstm_pallas as lp

    kernel, *_, dtype, _, fused = CASES[name]
    params, fc, x, dy = case_arrays(name)
    dt = jnp.dtype(dtype)

    def cast(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), tree)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    with jax.default_matmul_precision("highest"):
        if kernel == "k1":
            return {"y": f32(lp.stacked_lstm2(cast(params), jnp.asarray(x, dt), cast(fc),
                                              interpret=True))}
        if kernel == "k5":
            bf16 = jax.tree_util.tree_map(lambda a: f32(jnp.asarray(a, jnp.bfloat16)), params)
            jparams = cast(params)
            jparams["int8_prepared"] = {k: jnp.asarray(v) for k, v in
                                        lp.prepare_quantized_lstm(bf16).items()}
            return {"y": f32(lp.stacked_lstm2_quantized(jparams, jnp.asarray(x, dt), cast(fc),
                                                        interpret=True))}

        def loss(p, xx, f):
            y = lp.stacked_lstm2_train(p, xx, f, 256, True)
            return jnp.sum(y.astype(jnp.float32) * dy), y

        before = lp.FUSED_WGRAD
        lp.FUSED_WGRAD = fused
        try:
            (value, y), (gp, gx, gfc) = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                           has_aux=True)(
                cast(params), jnp.asarray(x, dt), cast(fc))
        finally:
            lp.FUSED_WGRAD = before
    grads = torch_layout(jax.tree_util.tree_map(f32, gp), jax.tree_util.tree_map(f32, gfc))
    return stored(name, {"y": f32(y), "value": np.float32(value), "dx": f32(gx),
                         **{f"d_{g}": a for g, a in zip(GRAD_NAMES, grads)}})


def generate(path: str = FIXTURE) -> None:
    arrays = {"cases": np.array(json.dumps(CASES))}
    for name in CASES:
        for key, value in run_case(name).items():
            arrays[f"{name}/{key}"] = value
        print(f"{name}: done")
    np.savez_compressed(path, **arrays)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(FIXTURE))))
    generate()
