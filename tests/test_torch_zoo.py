"""The port's module zoo (fullsubnet_plus_torch nn/ and dsp/) against the JAX
package's, on the CPU: every channel attention, norm, feature norm, the
ideal ratio mask, the recurrent and TCN sequence models, the complex
sequence model, the 2-D causal conv blocks (forward and gradients), the
multi-channel DSP and the initializers. Inputs are
seeded with numpy, sizes tiny; the JAX side runs at HIGHEST matmul
precision, the port in float32. Forwards agree at >= 80 dB; the norms whose
variance is E[x^2] - mean^2 from float32 running sums agree to a relative
1e-4, the summation order's limit (as tests/test_mask_norms_unfold.py
holds JAX to the reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as nn_functional

from fullsubnet_plus_tpu.dsp import mask as jmask
from fullsubnet_plus_tpu.dsp import multichannel as jmc
from fullsubnet_plus_tpu.dsp import norms as jnorms
from fullsubnet_plus_tpu.nn import attention as jatt
from fullsubnet_plus_tpu.nn import feature_norm as jfn
from fullsubnet_plus_tpu.nn import init as jinit
from fullsubnet_plus_tpu.nn import sequence as jseq
from fullsubnet_plus_tpu.nn import tcn as jtcn
from fullsubnet_plus_torch.dsp import mask as tmask
from fullsubnet_plus_torch.dsp import multichannel as tmc
from fullsubnet_plus_torch.dsp import norms as tnorms
from fullsubnet_plus_torch.io.convert import (
    attention_table,
    causal_block_table,
    sequence_model_table,
    state_dict_from_table,
    tree_from_table,
)
from fullsubnet_plus_torch.nn import attention as tatt
from fullsubnet_plus_torch.nn import feature_norm as tfn
from fullsubnet_plus_torch.nn import init as tinit
from fullsubnet_plus_torch.nn import tcn as ttcn
from fullsubnet_plus_torch.nn.layers import reset_parameters
from fullsubnet_plus_torch.nn.sequence import ComplexSequenceModel, SequenceModel

HIGHEST = jax.default_matmul_precision("highest")


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


def _floats(a):
    """A complex array as its float32 (real, imag) pairs."""
    return np.ascontiguousarray(np.asarray(a)).view(np.float32)


def _jit(fn, *args):
    """`fn` on the JAX side as one compiled program at HIGHEST precision
    (cheaper than op-by-op dispatch of a many-op module)."""
    with HIGHEST:
        return np.asarray(jax.jit(fn)(*args))


def _seeded(module, table, seed=1):
    """`module` with seeded weights and its JAX tree through the bridge's
    table rows (written for a prefix "m"), checked to load back bit-equal."""
    reset_parameters(module, torch.Generator().manual_seed(seed))
    state = {f"m.{k}": v for k, v in module.state_dict().items()}
    params = tree_from_table(state, table)["m"]
    back = state_dict_from_table({"m": params}, table)
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
    return module, params


# -- channel attentions -------------------------------------------------------

@pytest.mark.parametrize("kind,masked", [
    ("SE", False), ("SE", True), ("ECA", False), ("ECA", True), ("CBAM", False),
    ("CBAM", True), ("DeepTSSE", False), ("TSSE_ATT", False)])
def test_attention_matches_jax(rng, kind, masked):
    x = rng.standard_normal((3, 24, 30)).astype(np.float32)
    valid = np.array([30, 17, 22]) if masked else None
    if masked:  # the masked pools expect zeros past each row's frames
        x = x * (np.arange(30)[None, None, :] < valid[:, None, None])
    module, params = _seeded(tatt.channel_attention(kind, 24, kersize=(3, 5, 7)),
                             attention_table("m", kind))
    ref = _jit(lambda x, v: jatt.channel_attention_apply(params, kind, x, kersize=(3, 5, 7),
                                                         valid=v),
               jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        out = module(torch.from_numpy(x),
                     valid=None if valid is None else torch.from_numpy(valid)).numpy()
    assert out.shape == x.shape
    assert _snr(ref, out) > 80.0


def test_tsse_weight_returns_its_gate(rng):
    x = rng.standard_normal((2, 16, 25)).astype(np.float32)
    module, params = _seeded(tatt.TSSEWeight(16), attention_table("m", "TSSE"), seed=2)
    with HIGHEST:
        ref_x, ref_gate = jax.jit(lambda x: jatt.tsse_weight_apply(params, x))(jnp.asarray(x))
    with torch.no_grad():
        out_x, gate = module(torch.from_numpy(x))
    assert gate.shape == (2, 16, 1)
    assert _snr(ref_x, out_x.numpy()) > 80.0 and _snr(ref_gate, gate.numpy()) > 80.0


@pytest.mark.parametrize("kind", ["DeepTSSE", "TSSE_ATT"])
def test_unmasked_attentions_refuse_valid(kind):
    """JAX asserts (nn/attention.py:351-353); the port raises, not pools unmasked."""
    x = np.zeros((2, 8, 12), np.float32)
    module, params = _seeded(tatt.channel_attention(kind, 8), attention_table("m", kind))
    with pytest.raises(AssertionError):
        jatt.channel_attention_apply(params, kind, jnp.asarray(x), valid=jnp.asarray([12, 9]))
    with pytest.raises(ValueError, match="masked pooling"):
        module(torch.from_numpy(x), valid=torch.tensor([12, 9]))


@pytest.mark.parametrize("kind,valid", [("TSSE_ATT", None), ("CBAM", [40, 21])])
def test_attention_bf16_stays_finite(rng, kind, valid):
    """The bf16 Enhancer casts the whole model: TSSE_ATT's sigmoid scores and
    CBAM's max over -inf stay finite."""
    module = tatt.channel_attention(kind, 16)
    reset_parameters(module, torch.Generator().manual_seed(0))
    x = 30 * rng.standard_normal((2, 16, 40)).astype(np.float32)
    kwargs = {} if valid is None else {"valid": torch.tensor(valid)}
    if valid is not None:
        x = x * (np.arange(40)[None, None, :] < np.array(valid)[:, None, None])
    out = module.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16), **kwargs)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


# -- norms ----------------------------------------------------------------------

NORM_RTOL = {"cumulative_layer_norm": 1e-4, "hybrid_norm": 1e-4}


@pytest.mark.parametrize("name", ["offline_laplace_norm", "offline_gaussian_norm",
                                  "cumulative_laplace_norm", "cumulative_layer_norm",
                                  "forgetting_norm", "hybrid_norm", "sband_forgetting_norm"])
def test_norm_matches_jax(rng, name):
    three_d = name in tnorms.THREE_D_ONLY
    shape = (2, 12, 30) if three_d else (2, 1, 12, 30)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1
    kwargs = {}
    if three_d:  # past the training length too: both regimes of alpha
        length = "train_sample_length" if name == "sband_forgetting_norm" else \
            "sample_length_in_training"
        kwargs = {length: 9}
    ref = np.asarray(getattr(jnorms, name)(jnp.asarray(x), **kwargs))
    out = getattr(tnorms, name)(torch.from_numpy(x), **kwargs).numpy()
    if name in NORM_RTOL:
        np.testing.assert_allclose(out, ref, rtol=NORM_RTOL[name], atol=1e-5)
    else:
        assert _snr(ref, out) > 80.0
    if three_d:
        with pytest.raises(ValueError, match=r"\[B, F, T\]"):
            getattr(tnorms, name)(torch.from_numpy(x[:, None]))
        return
    # get_norm's form with valid frame counts: masked statistics or the
    # causal norm with its padded region zeroed
    valid = np.array([30, 19])
    ref = np.asarray(jnorms.get_norm(name)(jnp.asarray(x), valid=jnp.asarray(valid)))
    out = tnorms.get_norm(name)(torch.from_numpy(x), valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(out, ref, rtol=NORM_RTOL.get(name, 1e-5), atol=1e-5)


def test_unknown_norm_raises():
    for get in (jnorms.get_norm, tnorms.get_norm):
        with pytest.raises(NotImplementedError):
            get("batch_norm")


@pytest.mark.parametrize("kwargs", [None, {}, {"cumulative": True}, {"use_mid_freq_mu": True},
                                    {"cumulative": True, "use_mid_freq_mu": True}])
def test_feature_norm_matches_jax(rng, kwargs):
    x = np.abs(rng.standard_normal((2, 2, 10, 16))).astype(np.float32) + 0.1
    if kwargs is None:  # cumulative_norm
        ref = jfn.cumulative_norm(jnp.asarray(x))
        out = tfn.cumulative_norm(torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    else:
        ref = jfn.cumulative_mag_spectral_norm(jnp.asarray(x), **kwargs)
        out = tfn.cumulative_mag_spectral_norm(torch.from_numpy(x), **kwargs)
        assert _snr(ref, out.numpy()) > 80.0


def test_ideal_ratio_mask_matches_jax(rng):
    noisy, clean = (np.abs(rng.standard_normal((2, 9, 7))).astype(np.float32) for _ in range(2))
    ref = jmask.build_ideal_ratio_mask(jnp.asarray(noisy), jnp.asarray(clean))
    out = tmask.build_ideal_ratio_mask(torch.from_numpy(noisy), torch.from_numpy(clean))
    assert out.shape == (2, 9, 7, 1)
    assert _snr(ref, out.numpy()) > 80.0


# -- sequence models ----------------------------------------------------------

@pytest.mark.parametrize("kind,layers,bidirectional", [
    ("LSTM", 1, False), ("LSTM", 3, False), ("LSTM", 2, True), ("GRU", 2, False),
    ("GRU", 1, True), ("TCN-subband", 2, False)])
def test_sequence_model_matches_jax(rng, kind, layers, bidirectional):
    x = rng.standard_normal((3, 10, 14)).astype(np.float32)  # [B, F, T]
    module, params = _seeded(SequenceModel(10, 4, 12, layers, bidirectional, kind, "Tanh"),
                             sequence_model_table("m", kind, layers, bidirectional), seed=3)
    ref = _jit(lambda x: jseq.sequence_model_apply(params, x, sequence_model=kind,
                                                   bidirectional=bidirectional,
                                                   output_activate_function="Tanh"),
               jnp.asarray(x))
    assert not module.fused
    with torch.no_grad():
        out = module(torch.from_numpy(x)).numpy()
        # JAX runs a quantized GRU as the float one (nn/sequence.py:179-184)
        np.testing.assert_array_equal(module(torch.from_numpy(x), quantized=True).numpy(), out)
    assert out.shape == (3, 4, 14)
    assert _snr(ref, out) > 80.0
    for method in (module.prepare_int8, lambda: module.shard_fold(["cpu"])):
        with pytest.raises(ValueError, match="no 2-layer LSTM"):
            method()


def test_sequence_model_gru_gradient_is_finite(rng):
    """A plain recurrent model trains by autograd through the loop."""
    module = SequenceModel(6, 2, 8, 2, False, "GRU")
    reset_parameters(module, torch.Generator().manual_seed(1))
    y = module(torch.from_numpy(rng.standard_normal((2, 6, 9)).astype(np.float32)))
    grads = torch.autograd.grad(y.square().mean(), list(module.parameters()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_complex_sequence_model_matches_jax(rng, kind):
    x = rng.standard_normal((2, 12, 9)).astype(np.float32)  # [B, 2F, T]
    table = []
    for part in ("real", "imag"):
        table += [(f"m/{part}_sequence_model/{p.split('/', 2)[2]}",
                   f"m.{part}_sequence_model.{k.split('.', 2)[2]}", tr)
                  for p, k, tr in sequence_model_table("m", kind)[:-2]]
        table += [(f"m/{part}_fc_output_layer/{n}", f"m.{part}_fc_output_layer.{n}", n == "weight")
                  for n in ("weight", "bias")]
    module, params = _seeded(ComplexSequenceModel(6, 3, 8, 2, sequence_model=kind,
                                                  output_activate_function="ReLU"), table, seed=4)
    ref = _jit(lambda x: jseq.complex_sequence_model_apply(
        params, x, sequence_model=kind, output_activate_function="ReLU"), jnp.asarray(x))
    with torch.no_grad():
        out = module(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 6, 9)
    assert _snr(ref, out) > 80.0
    with pytest.raises(ValueError, match="bidirectional"):
        ComplexSequenceModel(6, 3, 8, bidirectional=True)


# -- multi-channel DSP --------------------------------------------------------

def test_multichannel_matches_jax(rng):
    y = rng.standard_normal((2, 8, 800)).astype(np.float32)
    spec_j = jmc.mc_stft(jnp.asarray(y), 64, 32, 64)
    spec_t = tmc.mc_stft(torch.from_numpy(y), 64, 32, 64)
    assert tuple(spec_t.shape) == spec_j.shape == (2, 8, 33, 26)
    assert _snr(_floats(spec_j), _floats(spec_t.numpy())) > 80.0
    spec = np.asarray(spec_j)

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    cases = [
        ("apply_crf_filter", (cplx(2, 33, 26, 3), cplx(2, 8, 33, 3, 26))),
        ("get_power_spectral_density_matrix", (spec.transpose(0, 2, 1, 3),)),
        ("apply_beamforming_vector", (cplx(2, 33, 26, 8), spec.transpose(0, 2, 1, 3))),
    ]
    for name, args in cases:
        ref = np.asarray(getattr(jmc, name)(*(jnp.asarray(a) for a in args)))
        out = getattr(tmc, name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
        assert _snr(_floats(ref), _floats(out.numpy())) > 80.0, name
    x = rng.standard_normal((2, 5, 7)).astype(np.float32)
    w, b = rng.standard_normal(5).astype(np.float32), rng.standard_normal(5).astype(np.float32)
    ref = jmc.channel_wise_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = tmc.channel_wise_layer_norm(*(torch.from_numpy(a) for a in (x, w, b)))
    assert _snr(ref, out.numpy()) > 80.0
    phase = rng.uniform(-np.pi, np.pi, (2, 8, 5, 4)).astype(np.float32)
    pairs = ((0, 4), (1, 5))
    for r, o in zip(jmc.compute_ipd(jnp.asarray(phase), pairs),
                    tmc.compute_ipd(torch.from_numpy(phase), pairs)):
        assert _snr(r, o.numpy()) > 80.0
    for sin in (False, True):
        jcfg = jmc.DirectionalFeatureConfig(n_fft=64, win_length=64, hop_length=32,
                                            use_sin_ipd=sin)
        tcfg = tmc.DirectionalFeatureConfig(n_fft=64, win_length=64, hop_length=32,
                                            use_sin_ipd=sin)
        feats_j = jmc.directional_features(jnp.asarray(y), jcfg)[0]
        feats_t = tmc.directional_features(torch.from_numpy(y), tcfg)[0]
        assert tuple(feats_t.shape) == feats_j.shape == (2, tcfg.directional_feature_dim, 26)
        assert tcfg.directional_feature_dim == jcfg.directional_feature_dim
        # LPS through a layer norm, the IPDs through the phase: 1e-4 absolute
        np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-4, rtol=0)


# -- 2-D causal conv blocks ----------------------------------------------------

def _causal_block(kind, rng, **kwargs):
    """A seeded block (conv: 4 -> 8 channels, trans_conv: 8 -> 4) with random
    BatchNorm2d statistics and affine, and its JAX tree through the table."""
    module = (ttcn.CausalConvBlock(4, 8, **kwargs) if kind == "conv"
              else ttcn.CausalTransConvBlock(8, 4, **kwargs))
    reset_parameters(module, torch.Generator().manual_seed(3))
    c = module.norm.weight.shape[0]
    with torch.no_grad():
        for name, lo, hi in (("weight", 0.5, 1.5), ("bias", -0.5, 0.5),
                             ("running_mean", -0.3, 0.3), ("running_var", 0.5, 2.0)):
            getattr(module.norm, name).copy_(torch.from_numpy(
                rng.uniform(lo, hi, c).astype(np.float32)))
    table = causal_block_table("m")
    state = {f"m.{k}": v for k, v in module.state_dict().items()}
    assert state.keys() == {key for _, key, _ in table}
    params = tree_from_table(state, table)["m"]
    back = state_dict_from_table({"m": params}, table)
    assert all(torch.equal(back[k], state[k]) for k in state)
    return module, params


def _assert_close(ref, out, name, scale=1.0):
    """>= 80 dB and max-abs <= 1e-5 * scale."""
    ref, out = np.asarray(ref), np.asarray(out)
    assert out.shape == ref.shape, name
    assert _snr(ref, out) >= 80, (name, _snr(ref, out))
    assert np.abs(ref - out).max() <= 1e-5 * scale, (name, np.abs(ref - out).max(), scale)


CAUSAL_CASES = [
    *(pytest.param("conv", act, tr, id=f"conv-{act}-{'train' if tr else 'eval'}")
      for act in ("ELU", "ReLU", "Tanh", "LeakyReLU") for tr in (False, True)),
    *(pytest.param("trans_conv", (last, pad), tr,
                   id=f"trans-{'last' if last else 'mid'}-pad{pad[0]}-{'train' if tr else 'eval'}")
      for last in (False, True) for pad in ((0, 0), (1, 0)) for tr in (False, True))]


@pytest.mark.parametrize("kind,option,training", CAUSAL_CASES)
def test_causal_conv_block_matches_jax(rng, kind, option, training):
    """Forward and the gradients of sum(out * w) with respect to x and every
    parameter, against JAX at HIGHEST precision; training mode (the batch's
    statistics) leaves the running statistics untouched. A parameter's
    gradient sums some 600-1200 products to values up to ~150, where a
    float32 ulp is 4-15e-6, so its max-abs bound is 1e-5 relative to its
    largest value; in training mode the conv bias's gradient is zero (the
    batch mean takes the bias out), and both sides hold it to float32 noise."""
    if kind == "conv":
        x = rng.standard_normal((2, 4, 32, 20)).astype(np.float32)
        module, params = _causal_block(kind, rng, activation=option)

        def apply(p, xx):
            return jtcn.causal_conv_block_apply(p, xx, activation=option, training=training)
    else:
        x = rng.standard_normal((2, 8, 15, 20)).astype(np.float32)
        last, pad = option
        module, params = _causal_block(kind, rng, is_last=last, output_padding=pad)

        def apply(p, xx):
            return jtcn.causal_trans_conv_block_apply(p, xx, is_last=last, output_padding=pad,
                                                      training=training)
    out_shape = (2, 8, 15, 20) if kind == "conv" else (2, 4, 31 + option[1][0], 20)
    w = rng.standard_normal(out_shape).astype(np.float32)

    def forward_and_grads(p, xx, ww):
        out, vjp = jax.vjp(apply, p, xx)
        return out, vjp(ww)

    with HIGHEST:
        ref, (ref_grads, ref_dx) = jax.jit(forward_and_grads)(params, x, w)
    stats = {k: v.clone() for k, v in module.named_buffers()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt, training=training)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_close(ref, out.detach(), "out")
    _assert_close(ref_dx, xt.grad, "dx")
    scale = np.abs(np.asarray(ref_grads["norm"]["bias"])).max()
    for name, p in module.named_parameters():
        group, leaf = name.split(".")
        ref_grad = np.asarray(ref_grads[group][leaf])
        if training and name == "conv.bias":
            assert max(np.abs(ref_grad).max(), p.grad.abs().max()) <= 1e-5 * scale
        else:
            _assert_close(ref_grad, p.grad, name, max(1.0, np.abs(ref_grad).max()))
    assert all(torch.equal(v, stats[k]) for k, v in module.named_buffers())


@pytest.mark.parametrize("stride,padding,output_padding", [
    ((1, 1), ((0, 0), (0, 0)), (0, 0)), ((2, 1), ((0, 0), (1, 1)), (1, 0)),
    ((2, 3), ((1, 2), (0, 1)), (1, 2))])
def test_conv2d_forms_match_torch_functional(rng, stride, padding, output_padding):
    """`conv2d` and `conv_transpose2d` (taps around one matmul) against
    torch.nn.functional's convolutions on the CPU, at strides and paddings
    beyond the blocks' own."""
    x = torch.from_numpy(rng.standard_normal((2, 3, 11, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 3, 3, 2)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    (f0, f1), (t0, t1) = padding
    ref = nn_functional.conv2d(nn_functional.pad(x, (t0, t1, f0, f1)), w, b, stride=stride)
    _assert_close(ref, ttcn.conv2d(x, w, b, stride=stride, padding=padding), "conv2d")
    wt = torch.from_numpy(rng.standard_normal((3, 5, 3, 2)).astype(np.float32))
    ref = nn_functional.conv_transpose2d(x, wt, b, stride=stride, output_padding=output_padding)
    out = ttcn.conv_transpose2d(x, wt, b, stride=stride, output_padding=output_padding)
    _assert_close(ref, out, "conv_transpose2d")


def test_causal_conv_blocks_bf16_stay_finite(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 20)).astype(np.float32))
    enc, _ = _causal_block("conv", rng)
    dec, _ = _causal_block("trans_conv", rng)
    enc, dec = enc.to(torch.bfloat16), dec.to(torch.bfloat16)
    y = enc(x.to(torch.bfloat16), training=True)
    back = dec(y, training=True)
    assert y.shape == (2, 8, 15, 20) and back.shape == (2, 4, 31, 20)
    assert back.dtype == torch.bfloat16 and torch.isfinite(back.float()).all()


def test_causal_conv_block_refuses_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        ttcn.CausalConvBlock(4, 8, activation="GELU")


# -- initializers ---------------------------------------------------------------

def test_reference_weight_init_keeps_structure_and_orthonormal_rows():
    """As tests/test_module_zoo.py holds the JAX scheme: the structure stays,
    w_hh (JAX layout [H, 4H]) has orthonormal rows; GroupNorm and PReLU keep
    their values; every other tensor is redrawn."""
    from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus, FullSubNetPlusConfig

    cfg = FullSubNetPlusConfig(num_freqs=17, sb_num_neighbors=2, fb_model_hidden_size=8,
                               sb_model_hidden_size=8, channel_attention_model="TSSE_ATT")
    model = FullSubNetPlus(cfg).init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tinit.reference_weight_init(model, torch.Generator().manual_seed(1))
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(after[k].shape == before[k].shape for k in before)
    for key in before:
        same = torch.equal(after[key], before[key])
        assert same == (".norm" in key or ".prelu" in key), key
    w_hh = after["sb_model.sequence_model.weight_hh_l0"].t()  # JAX layout [H, 4H]
    np.testing.assert_allclose((w_hh @ w_hh.t()).numpy(), np.eye(8), atol=1e-5)
    w = after["sb_model.fc_output_layer.weight"]
    assert abs(float(w.std()) - np.sqrt(2.0 / sum(w.shape))) < 0.5 * np.sqrt(2.0 / sum(w.shape))


def test_init_helpers_match_jax_bounds():
    g = torch.Generator().manual_seed(0)
    w = tinit.kaiming_uniform((64, 50), 50, g)
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / 50)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    jw = np.asarray(jinit.kaiming_uniform(jax.random.PRNGKey(0), (64, 50), 50))
    assert abs(np.abs(jw).max() - bound) < 0.1 * bound
    b = tinit.uniform_fan_in((100,), 25, g)
    assert float(b.abs().max()) <= 0.2
    assert not tinit.uniform_fan_in((3,), 0, g).any()
    for shape in ((4, 12), (12, 4)):
        q = tinit.orthogonal(shape, g).double()
        small = min(shape)
        gram = q @ q.t() if shape[0] < shape[1] else q.t() @ q
        np.testing.assert_allclose(gram.numpy(), np.eye(small), atol=1e-6)
