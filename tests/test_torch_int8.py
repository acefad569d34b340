"""The port's int8 serving route (ops/lstm2_int8.py, LSTM2.prepare_int8, the
quantized SequenceModel route, Enhancer(compute_dtype="int8")) against the
JAX package's, on the CPU.

The same weights (JAX init, cast to bf16 as the JAX Enhancer casts them) and
numpy inputs go through both. Quantization must agree bit for bit; the plain
int8 LSTM against the TPU kernel `stacked_lstm2_quantized` in interpret
mode, the int8 Enhancer against float32 and against the JAX int8 Enhancer,
each with the floor stated in the test.

`test_int8_kernel_matches_plain_on_cuda` needs an NVIDIA GPU and skips
without one; chip_smoke.py makes the same comparison at the serving shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.io import torch_convert as jconv
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.nn.init import linear_init
from fullsubnet_plus_tpu.nn.lstm import lstm_init
from fullsubnet_plus_tpu.ops import lstm_pallas
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io.convert import state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.nn import lstm as port_lstm
from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.nn.lstm import LSTM2
from fullsubnet_plus_torch.nn.sequence import SequenceModel
from fullsubnet_plus_torch.ops import lstm2 as ops_lstm2
from fullsubnet_plus_torch.ops import lstm2_int8 as ops_int8

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


def _bf16(tree):
    """A JAX tree rounded to bf16, as float32 numpy (exact bf16 values)."""
    return jax.tree_util.tree_map(
        lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), tree)


def _port_lstm(params, fc):
    """The JAX LSTM and Linear carried into the port's modules."""
    d, h = params["layers"][0]["w_ih"].shape[0], params["layers"][0]["w_hh"].shape[0]
    lstm, linear = LSTM2(d, h), Linear(h, fc["weight"].shape[1])
    sd = {}
    jconv.export_lstm(sd, params, "m")
    lstm.load_state_dict({k.removeprefix("m."): torch.from_numpy(v) for k, v in sd.items()})
    sd = {}
    jconv.export_linear(sd, fc, "m")
    linear.load_state_dict({k.removeprefix("m."): torch.from_numpy(v) for k, v in sd.items()})
    return lstm, linear


def _lstm_case(seed, d, h, o):
    params = jax.tree_util.tree_map(np.asarray, lstm_init(jax.random.PRNGKey(seed), d, h, 2))
    fc = jax.tree_util.tree_map(np.asarray, linear_init(jax.random.PRNGKey(seed + 1), h, o))
    return params, fc


def test_prepare_quantized_lstm_matches_jax_bit_for_bit():
    """Per-column int8 weights and scales from bf16-cast weights: the port's
    numpy function and LSTM2.prepare_int8 against the JAX package's."""
    params, fc = _lstm_case(7, 34, 64, 2)
    params, fc = _bf16(params), _bf16(fc)
    for layer, name in ((0, "w_hh"), (1, "w_ih"), (1, "w_hh")):
        params["layers"][layer][name][:, 5] = 0.0  # all-zero columns take scale 1
    ref = lstm_pallas.prepare_quantized_lstm(params)
    l1, l2 = params["layers"]
    got = ops_int8.prepare_quantized_lstm(
        l1["w_hh"], np.concatenate([l2["w_ih"], l2["w_hh"]], axis=0))
    for key in ("u1q", "w2q"):
        assert got[key].dtype == np.int8
        np.testing.assert_array_equal(got[key], ref[key])
    for key in ("s1", "s2"):
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], ref[key].reshape(-1))
    # the module path casts its (here already bf16) weights and gets the same
    lstm, linear = _port_lstm(params, fc)
    w = lstm.prepare_int8(linear)
    np.testing.assert_array_equal(w.u1q.numpy(), ref["u1q"])
    np.testing.assert_array_equal(w.w2q.numpy(), ref["w2q"])
    np.testing.assert_array_equal(w.s1.numpy(), ref["s1"].reshape(-1))
    np.testing.assert_array_equal(w.s2.numpy(), ref["s2"].reshape(-1))


def test_prepare_int8_casts_float32_weights_to_bf16_first():
    """A float32 module quantizes its bf16-rounded weights, as the JAX
    Enhancer quantizes after casting its parameters to bf16."""
    params, fc = _lstm_case(8, 10, 32, 2)
    lstm, linear = _port_lstm(params, fc)
    ref = lstm_pallas.prepare_quantized_lstm(_bf16(params))
    w = lstm.prepare_int8(linear)
    np.testing.assert_array_equal(w.u1q.numpy(), ref["u1q"])
    np.testing.assert_array_equal(w.s2.numpy(), ref["s2"].reshape(-1))
    assert w.w1.dtype == torch.bfloat16 and w.fc_w.dtype == torch.float32


def test_prepare_int8_rejects_mismatched_shapes(monkeypatch):
    """The prepared weights are checked against the float weights (the port
    does not trust them unchecked, as the JAX int8 path does)."""
    params, fc = _lstm_case(9, 10, 32, 2)
    lstm, linear = _port_lstm(params, fc)
    real = ops_int8.prepare_quantized_lstm

    def transposed(u1, w2):
        q = real(u1, w2)
        return {**q, "u1q": np.ascontiguousarray(q["u1q"].T)}

    monkeypatch.setattr(port_lstm, "prepare_quantized_lstm", transposed)
    with pytest.raises(ValueError, match="u1q"):
        lstm.prepare_int8(linear)


def test_pack_k_quads_layout():
    """Word (q, m) holds rows 4q..4q+3 of column m, little-endian, and
    unpacking restores the int8 matrix."""
    wq = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, (8, 5)).astype(np.int8))
    packed = ops_int8.pack_k_quads(wq)
    assert packed.shape == (2, 5) and packed.dtype == torch.int32
    b = wq.numpy().astype(np.int64) & 0xFF
    word = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24)
    assert np.array_equal(packed[1].numpy().astype(np.int64) & 0xFFFFFFFF, word)
    assert torch.equal(ops_int8.unpack_k_quads(packed), wq)


@pytest.mark.parametrize("n,t,d,h,o", [(100, 17, 34, 64, 2), (20, 9, 10, 16, 3)])
def test_int8_plain_matches_jax_kernel(rng, n, t, d, h, o):
    """The plain int8 LSTM against `stacked_lstm2_quantized` (interpret
    mode) on the same bf16 weights, prepared int8 weights and bf16 input;
    the first shape leaves a ragged last tile. Floor 40 dB (the bar
    chip_smoke.py holds the CUDA kernel to); measured on an x86 CPU: the
    outputs are identical (max-abs 0, SNR above 300 dB), as the int32 sums
    are exact and the float steps round at the same points."""
    params, fc = _lstm_case(n + t, d, h, o)
    params, fc = _bf16(params), _bf16(fc)
    x = (0.5 * rng.standard_normal((n, d, t))).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jparams["int8_prepared"] = {k: jnp.asarray(v) for k, v in
                                lstm_pallas.prepare_quantized_lstm(params).items()}
    jfc = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), fc)
    ref = np.asarray(lstm_pallas.stacked_lstm2_quantized(
        jparams, jnp.asarray(x, jnp.bfloat16), jfc, 64, True).astype(jnp.float32))
    lstm, linear = _port_lstm(params, fc)
    out = ops_int8.lstm2_int8_fc(torch.from_numpy(x).to(torch.bfloat16),
                                 lstm.prepare_int8(linear))
    assert out.dtype == torch.bfloat16 and out.shape == (n, t, o)
    assert _snr(ref, out.float().numpy()) >= 40.0, _snr(ref, out.float().numpy())


def test_int8_plain_close_to_float32(rng):
    """int8 against the port's float32 plain LSTM: SNR > 30 dB, the bar of
    tests/test_pallas_lstm.py::test_pallas_quantized_kernel_snr (measured
    44.8 dB on an x86 CPU)."""
    params, fc = _lstm_case(11, 34, 64, 2)
    x = (0.5 * rng.standard_normal((64, 34, 21))).astype(np.float32)
    lstm, linear = _port_lstm(params, fc)
    ref = ops_lstm2.lstm2_fc(torch.from_numpy(x), lstm.packed(linear)).numpy()
    out = ops_int8.lstm2_int8_fc(torch.from_numpy(x).to(torch.bfloat16),
                                 lstm.prepare_int8(linear)).float().numpy()
    assert np.isfinite(out).all()
    assert _snr(ref, out) > 30.0, _snr(ref, out)


def test_int8_wrapper_rejects_bad_inputs():
    params, fc = _lstm_case(12, 10, 32, 2)
    lstm, linear = _port_lstm(params, fc)
    w = lstm.prepare_int8(linear)
    with pytest.raises(TypeError, match="bfloat16"):
        ops_int8.lstm2_int8_fc(torch.zeros(3, 10, 4), w)
    with pytest.raises(ValueError, match="w1"):
        ops_int8.lstm2_int8_fc(torch.zeros(3, 12, 4, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="unsupported device"):
        ops_int8.lstm2_int8_fc(torch.zeros(3, 10, 4, dtype=torch.bfloat16, device="meta"), w)


def test_quantized_route_needs_prepared_weights():
    model = SequenceModel(10, 2, 32)
    x = torch.zeros(3, 10, 4, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="prepare_int8"):
        model.to(torch.bfloat16)(x, quantized=True)
    model.prepare_int8()
    assert model(x, quantized=True).shape == (3, 2, 4)


def test_int8_shared_memory_fits_the_shipped_shape():
    assert ops_int8.shared_memory_bytes(34, 384, 2) <= ops_int8.SMEM_LIMIT


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


@pytest.fixture(scope="module")
def noisy():
    return (0.1 * np.random.default_rng(5).standard_normal((2, 4000))).astype(np.float32)


def _port(params, **kw):
    return Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                    device="cpu", **ACOUSTICS, **kw)


def test_int8_enhancer_close_to_float32(tiny_params, noisy):
    """> 15 dB against float32, the bar of
    tests/test_enhance_modes.py::test_int8_enhance_close_to_fp32
    (measured 45.9 dB on an x86 CPU)."""
    e = _port(tiny_params, compute_dtype="int8")
    assert e.model.config.quantized_lstm and e.dtype == torch.bfloat16
    assert e.model.sb_model.int8_weights is not None
    out = e.enhance_batch(noisy)
    assert np.isfinite(out).all()
    assert _snr(_port(tiny_params).enhance_batch(noisy), out) > 15.0


def test_int8_enhancer_matches_jax_int8(tiny_params, noisy, monkeypatch):
    """The port's int8 Enhancer against the JAX package's, whose quantized
    kernel runs in interpret mode (FORCE_PALLAS_INTERPRET, as its own test
    does), on a length-masked batch. Floor 28 dB: 10 dB under the 38.3 dB
    measured on an x86 CPU (53.3 dB without lengths). Both run bf16 models
    through 8 TCN blocks and the cIRM, rounding at the same points but
    summing in other orders."""
    import fullsubnet_plus_tpu.nn.sequence as jseq

    monkeypatch.setattr(jseq, "FORCE_PALLAS_INTERPRET", True)
    ref = JEnhancer(J_MODEL, JConfig(**TINY), tiny_params, compute_dtype="int8",
                    **ACOUSTICS).enhance_batch(noisy, lengths=[3000, 4000])
    out = _port(tiny_params, compute_dtype="int8").enhance_batch(noisy, lengths=[3000, 4000])
    assert _snr(ref, out) >= 28.0, _snr(ref, out)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(3 * 257, 37), (100, 9)])
def test_int8_kernel_matches_plain_on_cuda(rng, n, t):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this comparison on the card")
    d, h, o = 34, 384, 2
    g = torch.Generator().manual_seed(0)
    lstm, linear = LSTM2(d, h), Linear(h, o)
    lstm.reset_parameters(g)
    linear.reset_parameters(g)
    w = lstm.to("cuda", torch.bfloat16).prepare_int8(linear.to("cuda", torch.bfloat16))
    x = torch.from_numpy((0.5 * rng.standard_normal((n, d, t))).astype(np.float32))
    x = x.to("cuda", torch.bfloat16)
    before = ops_int8.LAUNCHES
    out = ops_int8.lstm2_int8_fc(x, w).float()
    torch.cuda.synchronize()
    assert ops_int8.LAUNCHES == before + 1
    ref = ops_int8.lstm2_int8_fc_reference(x, w).float()
    snr = 10 * torch.log10(ref.pow(2).sum() / (out - ref).pow(2).sum().clamp_min(1e-30))
    assert snr >= 40.0, float(snr)
