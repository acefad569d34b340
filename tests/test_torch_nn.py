"""The port's layers (fullsubnet_plus_torch/nn, ops/lstm2.py) against the
JAX package's, on the CPU: the same weights (JAX init, carried over as
numpy) and the same numpy inputs, JAX at HIGHEST matmul precision, the port
in float32. The LSTM tolerance (atol 3e-5, rtol 1e-4) is the one
tests/test_pallas_lstm.py holds the TPU kernel to.

The CUDA kernel's tests are in tests/test_torch_cuda_kernels.py, which
imports no JAX and so runs on the card's machine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.io import torch_convert as jconv
from fullsubnet_plus_tpu.nn.attention import tsse_apply, tsse_init
from fullsubnet_plus_tpu.nn.init import linear_init
from fullsubnet_plus_tpu.nn.lstm import lstm_apply, lstm_init
from fullsubnet_plus_tpu.nn.sequence import sequence_model_apply, sequence_model_init
from fullsubnet_plus_tpu.nn.tcn import tcn_block_apply, tcn_block_init
from fullsubnet_plus_tpu.ops.lstm_pallas import stacked_lstm2
from fullsubnet_plus_torch.nn.attention import TSSE
from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.nn.lstm import LSTM2
from fullsubnet_plus_torch.nn.sequence import SequenceModel
from fullsubnet_plus_torch.nn.tcn import TCNBlock, conv1d
from fullsubnet_plus_torch.ops import lstm2 as ops_lstm2


def _exported(export, params, *args):
    """The JAX package's reference-layout export, as torch tensors with the
    module prefix "m." dropped."""
    out = {}
    export(out, params, "m", *args)
    return {k.removeprefix("m."): torch.from_numpy(v) for k, v in out.items()}


def _valid(v):
    return (None, None) if v is None else (jnp.asarray(v, jnp.int32), torch.tensor(v))


@pytest.mark.parametrize("dilation,valid", [(1, None), (5, None), (2, [9, 13]), (9, [20, 6])])
def test_tcn_block_matches_jax(rng, dilation, valid):
    c, t = 17, 20
    params = tcn_block_init(jax.random.PRNGKey(dilation), c, 64, c)
    x = rng.standard_normal((2, c, t)).astype(np.float32)
    if valid is not None:  # the masked path expects zeros past each row's end
        x *= (np.arange(t)[None, :] < np.asarray(valid)[:, None])[:, None, :]
    jv, tv = _valid(valid)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(tcn_block_apply(params, jnp.asarray(x), dilation=dilation, valid=jv))
    block = TCNBlock(c, hidden=64, dilation=dilation)
    block.load_state_dict(_exported(jconv.export_tcn_block, params), strict=True)
    out = block(torch.from_numpy(x), valid=tv).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("valid", [None, [14, 30]])
def test_tcn_sequence_model_matches_jax(rng, valid):
    """The 8-block stack (hidden 512 hard-coded), ReLU, Linear, ReLU."""
    c, t = 9, 30
    params = sequence_model_init(jax.random.PRNGKey(1), c, c, 16, 2, False, "TCN")
    x = rng.standard_normal((2, c, t)).astype(np.float32)
    if valid is not None:
        x *= (np.arange(t)[None, :] < np.asarray(valid)[:, None])[:, None, :]
    jv, tv = _valid(valid)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(sequence_model_apply(
            params, jnp.asarray(x), sequence_model="TCN", output_activate_function="ReLU",
            valid=jv))
    model = SequenceModel(c, c, 16, sequence_model="TCN", output_activate_function="ReLU")
    model.load_state_dict(_exported(jconv.export_sequence_model, params, "TCN"), strict=True)
    out = model(torch.from_numpy(x), valid=tv).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("valid", [None, [12, 25]])
def test_tsse_matches_jax(rng, valid):
    c, t = 33, 25
    params = tsse_init(jax.random.PRNGKey(2), c)
    x = np.abs(rng.standard_normal((2, c, t))).astype(np.float32)
    if valid is not None:
        x *= (np.arange(t)[None, :] < np.asarray(valid)[:, None])[:, None, :]
    jv, tv = _valid(valid)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(tsse_apply(params, jnp.asarray(x), valid=jv))
    module = TSSE(c)
    module.load_state_dict(_exported(jconv.export_tsse, params), strict=True)
    out = module(torch.from_numpy(x), valid=tv).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_conv1d_rejects_other_forms():
    with pytest.raises(ValueError, match="depthwise and 1x1"):
        conv1d(torch.zeros(1, 4, 8), torch.zeros(4, 2, 3), groups=2)


def _port_lstm(params, fc):
    """The JAX LSTM and Linear carried into the port's modules."""
    d, h = params["layers"][0]["w_ih"].shape[0], params["layers"][0]["w_hh"].shape[0]
    lstm = LSTM2(d, h)
    sd = {}
    jconv.export_lstm(sd, params, "m")
    lstm.load_state_dict({k.removeprefix("m."): torch.from_numpy(v) for k, v in sd.items()})
    linear = Linear(h, fc["weight"].shape[1])
    linear.load_state_dict(_exported(jconv.export_linear, fc))
    return lstm, linear


@pytest.mark.parametrize("n,t,d,h,o", [(100, 17, 34, 64, 2), (37, 9, 12, 32, 3)])
def test_lstm2_plain_matches_jax_scan_and_kernel(rng, n, t, d, h, o):
    """The plain version against JAX lstm_apply + Linear, and against the
    TPU kernel itself (stacked_lstm2, interpret mode)."""
    params = jax.tree_util.tree_map(np.asarray, lstm_init(jax.random.PRNGKey(n), d, h, 2))
    fc = jax.tree_util.tree_map(np.asarray, linear_init(jax.random.PRNGKey(t), h, o))
    x = (0.5 * rng.standard_normal((n, d, t))).astype(np.float32)  # [N, D, T] fold
    with jax.default_matmul_precision("highest"):
        hid, _ = lstm_apply(params, jnp.swapaxes(jnp.asarray(x), 1, 2))
        ref_scan = np.asarray(hid @ fc["weight"] + fc["bias"])
        ref_kernel = np.asarray(stacked_lstm2(params, jnp.asarray(x), fc, tile_n=64,
                                              interpret=True))
    lstm, linear = _port_lstm(params, fc)
    out = ops_lstm2.lstm2_fc(torch.from_numpy(x), lstm.packed(linear)).numpy()
    assert out.shape == (n, t, o)
    np.testing.assert_allclose(out, ref_scan, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(out, ref_kernel, atol=3e-5, rtol=1e-4)


def test_lstm2_bf16_plain_rounds_like_the_tpu_kernel(rng):
    """bf16 weights and input: h is rounded to bf16 before each product and
    the output is bf16, as stacked_lstm2 computes it (interpret mode)."""
    n, t, d, h, o = 40, 7, 34, 32, 2
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32)),
        lstm_init(jax.random.PRNGKey(4), d, h, 2))
    fc = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32)),
        linear_init(jax.random.PRNGKey(5), h, o))
    x = (0.5 * rng.standard_normal((n, d, t))).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jfc = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), fc)
    ref = np.asarray(stacked_lstm2(jparams, jnp.asarray(x, jnp.bfloat16), jfc, tile_n=64,
                                   interpret=True).astype(jnp.float32))
    lstm, linear = _port_lstm(params, fc)
    lstm, linear = lstm.to(torch.bfloat16), linear.to(torch.bfloat16)
    out = ops_lstm2.lstm2_fc(torch.from_numpy(x).to(torch.bfloat16), lstm.packed(linear))
    assert out.dtype == torch.bfloat16
    # both round the same float32 values to bf16; sums in another order can
    # land on the neighbouring bf16 value (2^-8 relative), and rarely more
    # after that difference feeds back through h
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_lstm2_shared_memory_fits_the_shipped_shape():
    """The kernel's block at D = 34, H = 384, O = 2 fits Hopper's limit: the
    float32 sweep's at its row tile (two operand buffers [16][48 + 768 + 4]
    float32, c1 and c2 [16][384] float32), and the bf16 sweep's at both row
    tiles (two operand buffers [R][64 + 768 + 8] bf16, c1 and c2)."""
    for rows in ops_lstm2.FWD_MMA_ROWS_PER_CTA[torch.float32]:
        smem = ops_lstm2.fwd_mma_shared_memory_bytes(rows, 34, 384, torch.float32)
        assert smem == 2 * 4 * rows * 820 + 2 * 4 * rows * 384 <= ops_lstm2.SMEM_LIMIT
    for rows in ops_lstm2.FWD_MMA_ROWS_PER_CTA[torch.bfloat16]:
        smem = ops_lstm2.fwd_mma_shared_memory_bytes(rows, 34, 384)
        assert smem == 2 * 2 * rows * 840 + 2 * 4 * rows * 384 <= ops_lstm2.SMEM_LIMIT
