"""The port's model variants (fullsubnet_plus_torch models/, io/, train/,
enhance.py) against the JAX package's, on the CPU: FullSubNet+ over the five
other channel attentions, the norms, a GRU and a TCN sub-band model and
`subband_num` 2 with ECA, FullSubNet with GRUs; the weight bridge and the
`.npz` checkpoints of the variants both ways; the joint-mask and residual
train steps over 3 Adam steps; every combination JAX refuses refused by the
port too; the Enhancer on the variants. Weights are seeded in the port and
carried to JAX through the bridge (the JAX init's op-by-op draws cost
seconds a tree); inputs are seeded with numpy, sizes tiny (n_fft 32, hidden
8). JAX runs at HIGHEST matmul precision, the port in float32 with its
kernels' plain versions (the CPU). Forwards agree at >= 80 dB, Adam's
losses within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.dsp import mask as jmask
from fullsubnet_plus_tpu.dsp.unfold import drop_band as jdrop_band
from fullsubnet_plus_tpu.io import checkpoint as jckpt
from fullsubnet_plus_tpu.models import FULLSUBNET as J_FSN
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet import FullSubNetConfig as JFsnConfig
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.nn import sequence as jseq
from fullsubnet_plus_tpu.train import loss as jloss
from fullsubnet_plus_tpu.train import step as jstep
from fullsubnet_plus_torch.dsp.mask import complex_mul, decompress_cirm
from fullsubnet_plus_torch.dsp.unfold import drop_band
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io import checkpoint as tckpt
from fullsubnet_plus_torch.io.convert import (
    jax_from_state_dict,
    sequence_model_table,
    state_dict_from_jax,
    tree_from_table,
)
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet import FullSubNet, FullSubNetConfig
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus, FullSubNetPlusConfig
from fullsubnet_plus_torch.nn.layers import reset_parameters
from fullsubnet_plus_torch.nn.sequence import SequenceModel
from fullsubnet_plus_torch.train import loss as tloss
from fullsubnet_plus_torch.train import step as tstep

TINY = dict(num_freqs=17, sb_num_neighbors=3, fb_model_hidden_size=8, sb_model_hidden_size=8)
ACOUSTICS = dict(n_fft=32, hop_length=16, win_length=32)
HIGHEST = jax.default_matmul_precision("highest")
VARIANTS = {
    "SE": dict(channel_attention_model="SE"),
    "ECA": dict(channel_attention_model="ECA"),
    "CBAM": dict(channel_attention_model="CBAM"),
    "DeepTSSE": dict(channel_attention_model="DeepTSSE"),
    "TSSE_ATT": dict(channel_attention_model="TSSE_ATT"),
    "gaussian": dict(norm_type="offline_gaussian_norm"),
    "cumulative_laplace": dict(norm_type="cumulative_laplace_norm"),
    "cumulative_layer": dict(norm_type="cumulative_layer_norm"),
    "GRU": dict(sequence_model="GRU"),
    "TCN": dict(sequence_model="TCN"),
    "subband2_ECA": dict(subband_num=2, channel_attention_model="ECA"),
}
MASKED = ("SE", "CBAM", "gaussian")  # each masks another statistic over time


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


def _model(kwargs, seed=0):
    """A seeded FullSubNet+ of the variant and its JAX tree through the bridge."""
    model = FullSubNetPlus(FullSubNetPlusConfig(**TINY, **kwargs)).init_weights(
        torch.Generator().manual_seed(seed))
    return model, jax_from_state_dict(model.state_dict())


def _views(rng, batch, frames):
    real, imag = (rng.standard_normal((batch, 1, TINY["num_freqs"], frames)).astype(np.float32)
                  for _ in range(2))
    return np.sqrt(real ** 2 + imag ** 2), real, imag


@pytest.mark.parametrize("name,masked", [(n, False) for n in VARIANTS]
                         + [(n, True) for n in MASKED] + [("fullsubnet_GRU", False)])
def test_variant_forward_matches_jax(rng, name, masked):
    views = _views(rng, 2, 24)
    kw = {"valid_frames": np.array([24, 15])} if masked else {}
    if masked:
        for v in views:
            v[1, :, :, 15:] = 0.0
    if name == "fullsubnet_GRU":
        model = FullSubNet(FullSubNetConfig(**TINY, sequence_model="GRU")).init_weights(
            torch.Generator().manual_seed(0))
        params, views = jax_from_state_dict(model.state_dict()), views[:1]
        with HIGHEST:
            ref = J_FSN.apply(params, jnp.asarray(views[0]),
                              JFsnConfig(**TINY, sequence_model="GRU"))
    else:
        model, params = _model(VARIANTS[name])
        with HIGHEST:
            ref = J_MODEL.apply(params, *(jnp.asarray(v) for v in views),
                                JConfig(**TINY, **VARIANTS[name]),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = model(*(torch.from_numpy(v) for v in views),
                    **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert out.shape == np.shape(ref) == (2, 2, TINY["num_freqs"], 24)
    assert _snr(ref, out) > 80.0


@pytest.mark.parametrize("name", ["TSSE_ATT", "CBAM", "GRU"])
def test_bridge_and_npz_round_trip(tmp_path, rng, name):
    """A JAX tree of the variant -> the port's state_dict -> the JAX tree, bit
    for bit (TSSE_ATT's d_k skipped on the way in, written back on the way
    out); a JAX-written `.npz` loads into the port strictly, and a
    port-written one into JAX, whose forward then agrees with the port's."""
    cfg = JConfig(**TINY, **VARIANTS[name])
    tree = jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(5), cfg))
    state = state_dict_from_jax(tree)
    assert not any("d_k" in k for k in state)
    back = jax_from_state_dict(state)
    flat, flat_back = tckpt.flat_from_nested(tree), tckpt.flat_from_nested(back)
    assert flat.keys() == flat_back.keys()
    for key, value in flat.items():
        np.testing.assert_array_equal(flat_back[key], value, err_msg=key)
    assert any(k.endswith("/d_k") for k in flat) == (name == "TSSE_ATT")

    jckpt.save_pytree(str(tmp_path / "jax.npz"), {"params": tree}, {"epoch": 1})
    model = FullSubNetPlus(FullSubNetPlusConfig(**TINY, **VARIANTS[name]))
    model.load_jax_params(tckpt.load_jax_params(str(tmp_path / "jax.npz")))
    assert all(torch.equal(model.state_dict()[k], v) for k, v in state.items())

    model.init_weights(torch.Generator().manual_seed(6))
    tckpt.save_flat(str(tmp_path / "port.npz"), {"params": jax_from_state_dict(model.state_dict())})
    loaded, _ = jckpt.load_flat(str(tmp_path / "port.npz"))
    jtree = jckpt.nested_from_flat({k.removeprefix("params/"): v for k, v in loaded.items()})
    assert tckpt.flat_from_nested(jtree).keys() == flat.keys()
    if name == "TSSE_ATT":  # the JAX forward needs the d_k the port wrote back
        views = _views(rng, 2, 24)
        with HIGHEST:
            ref = J_MODEL.apply(jtree, *(jnp.asarray(v) for v in views), cfg)
        with torch.no_grad():
            out = model(*(torch.from_numpy(v) for v in views)).numpy()
        assert _snr(ref, out) > 80.0


def test_tsse_att_train_state_resumes_in_either_package():
    """A TSSE_ATT train state in the JAX package's flat `.npz` keys: the port
    writes d_k into the parameters only, reads its own file back, and the
    JAX package restores it into its own TrainState template."""
    model = _model(VARIANTS["TSSE_ATT"])[0]
    state = tstep.init_train_state(model, tstep.make_optimizer(), device="cpu")
    flat = tckpt.flat_from_train_state(state)
    assert any(k.startswith("params/") and k.endswith("/d_k") for k in flat)
    assert not any(k.startswith("opt_state/") and k.endswith("/d_k") for k in flat)
    again = tstep.init_train_state(FullSubNetPlus(model.config), tstep.make_optimizer(),
                                   device="cpu")
    again.load_state_dict(tckpt.train_state_from_flat(flat))
    assert all(torch.equal(a, b) for a, b in zip(again.model.parameters(), model.parameters()))
    cfg = JConfig(**TINY, **VARIANTS["TSSE_ATT"])
    template = jstep.init_train_state(J_MODEL.init(jax.random.PRNGKey(0), cfg),
                                      jstep.make_optimizer())
    restored = jckpt.restore_like(template, flat)
    params = tckpt.flat_from_nested(jax.tree_util.tree_map(np.asarray, restored.params))
    for key, value in params.items():
        np.testing.assert_array_equal(value, flat[f"params/{key}"], err_msg=key)


# -- the joint-mask and residual train steps ------------------------------------

F_BINS = ACOUSTICS["n_fft"] // 2 + 1


def _batches(rng, steps=3, batch=4, samples=800):
    out = []
    for _ in range(steps):
        clean = (0.3 * rng.standard_normal((batch, samples))).astype(np.float32)
        noisy = (clean + 0.2 * rng.standard_normal((batch, samples))).astype(np.float32)
        out.append((noisy, clean))
    return out


def _joint_outputs(o, batch, frames, drop):
    """[B, 3F, T] -> (RM [B, 1, F, T], cRM [B, 2, F', T])."""
    o = o.reshape(batch, 3, F_BINS, frames)
    return o[:, :1], drop(o[:, 1:])


@pytest.mark.parametrize("kind", ["joint_mask", "residual"])
def test_joint_mask_and_residual_steps_match_jax(rng, kind):
    """3 Adam steps of each step against JAX's from the same weights: an
    LSTM sequence model (the kernels' route; plain on the CPU) maps the
    noisy magnitude to the step's pair of outputs."""
    out_ch = 3 * F_BINS if kind == "joint_mask" else 2 * F_BINS
    model = SequenceModel(F_BINS, out_ch, 8)
    reset_parameters(model, torch.Generator().manual_seed(7))
    params = tree_from_table({f"m.{k}": v for k, v in model.state_dict().items()},
                             sequence_model_table("m", "LSTM"))["m"]
    alpha = 0.7

    def jax_forward(p, mag, real, imag):
        o = jseq.sequence_model_apply(p, mag, sequence_model="LSTM", fast=True)
        batch, _, frames = o.shape
        if kind == "joint_mask":
            rm, crm = _joint_outputs(o, batch, frames, lambda x: jdrop_band(x, 2))
            return jax.nn.sigmoid(rm), jnp.tanh(crm)
        cirm = jnp.tanh(o.reshape(batch, 2, F_BINS, frames))
        d = jmask.decompress_cirm(jnp.moveaxis(cirm, 1, -1))
        r, i = jmask.complex_mul(real, imag, d[..., 0], d[..., 1])
        return cirm, jnp.stack([r, i], axis=1)

    def torch_forward(m, mag, real, imag):
        o = m(mag)
        batch, _, frames = o.shape
        if kind == "joint_mask":
            rm, crm = _joint_outputs(o, batch, frames, lambda x: drop_band(x, 2))
            return torch.sigmoid(rm), torch.tanh(crm)
        cirm = torch.tanh(o.reshape(batch, 2, F_BINS, frames))
        d = decompress_cirm(cirm.permute(0, 2, 3, 1))
        r, i = complex_mul(real, imag, d[..., 0], d[..., 1])
        return cirm, torch.stack([r, i], dim=1)

    if kind == "joint_mask":
        jmake, tmake, kw = (jstep.make_joint_mask_train_step, tstep.make_joint_mask_train_step,
                            {"num_groups": 2})
    else:
        jmake, tmake, kw = jstep.make_residual_train_step, tstep.make_residual_train_step, {}
    jopt = jstep.make_optimizer()
    jstate = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jopt)
    jrun = jmake(jax_forward, jopt, jloss.mse_loss, alpha=alpha, **kw, **ACOUSTICS)
    topt = tstep.make_optimizer()
    tstate = tstep.init_train_state(model, topt, device="cpu")
    trun = tmake(torch_forward, topt, tloss.mse_loss, alpha=alpha, device="cpu", **kw,
                 **ACOUSTICS)
    for noisy, clean in _batches(rng):
        with HIGHEST:
            jstate, jm = jrun(jstate, jnp.asarray(noisy), jnp.asarray(clean))
        tstate, tm = trun(tstate, noisy, clean)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(tstate.step) == 3 and int(tstate.opt_state.count) == 3
    want = tckpt.flat_from_nested(jax.tree_util.tree_map(np.asarray, jstate.params))
    state = {f"m.{k}": v for k, v in model.state_dict().items()}
    got = tckpt.flat_from_nested(tree_from_table(state, sequence_model_table("m", "LSTM"))["m"])
    assert got.keys() == want.keys()
    for path, value in got.items():
        np.testing.assert_allclose(value, want[path], rtol=0, atol=1e-5, err_msg=path)


# -- refusals -------------------------------------------------------------------

REFUSALS = {
    # name: (port config, JAX config, forward kwargs, where JAX refuses)
    "subband2_SE": (dict(subband_num=2, channel_attention_model="SE"), "init", {}),
    "subband2_ECA_valid": (dict(subband_num=2, channel_attention_model="ECA"), "apply",
                           {"valid_frames": [12, 9]}),
    "DeepTSSE_valid": (dict(channel_attention_model="DeepTSSE"), "apply",
                       {"valid_frames": [12, 9]}),
    "TSSE_ATT_valid": (dict(channel_attention_model="TSSE_ATT"), "apply",
                       {"valid_frames": [12, 9]}),
    "forgetting_norm": (dict(norm_type="forgetting_norm"), "apply", {}),
    "hybrid_norm": (dict(norm_type="hybrid_norm"), "apply", {}),
    "sband_forgetting_norm": (dict(norm_type="sband_forgetting_norm"), "apply", {}),
    "sequence_model_TCN-subband": (dict(sequence_model="TCN-subband"), "init", {}),
    "attention_unknown": (dict(channel_attention_model="GAT"), "init", {}),
    "norm_unknown": (dict(norm_type="batch_norm"), "apply", {}),
}


@pytest.mark.parametrize("name", list(REFUSALS) + ["fullsubnet_TCN"])
def test_refused_combinations_are_refused_by_both(rng, name):
    if name == "fullsubnet_TCN":
        with pytest.raises(AssertionError):
            J_FSN.init(jax.random.PRNGKey(0), JFsnConfig(**TINY, sequence_model="TCN"))
        with pytest.raises(ValueError, match="GRU or LSTM"):
            FullSubNet(FullSubNetConfig(**TINY, sequence_model="TCN"))
        return
    kwargs, where, forward = REFUSALS[name]
    jcfg = JConfig(**TINY, **kwargs)
    views = _views(rng, 2, 12)
    if where == "init":
        with pytest.raises((AssertionError, ValueError, NotImplementedError)):
            J_MODEL.init(jax.random.PRNGKey(0), jcfg)
    else:
        # the JAX tree has the default norm's structure (a norm has no weights)
        buildable = {k: v for k, v in kwargs.items() if k != "norm_type"}
        params = _model(buildable)[1]
        jkw = {k: jnp.asarray(v) if k == "valid_frames" else v for k, v in forward.items()}
        with pytest.raises((AssertionError, NotImplementedError)):
            J_MODEL.apply(params, *(jnp.asarray(v) for v in views), jcfg, **jkw)
    with pytest.raises((ValueError, NotImplementedError)):
        model = FullSubNetPlus(FullSubNetPlusConfig(**TINY, **kwargs))
        model(*(torch.from_numpy(v) for v in views),
              **{k: torch.tensor(v) if k == "valid_frames" else v for k, v in forward.items()})


# -- the Enhancer on the variants -------------------------------------------------

def _enhancer(kwargs, **kw):
    model = FullSubNetPlus(FullSubNetPlusConfig(**TINY, **kwargs)).init_weights(
        torch.Generator().manual_seed(8))
    return Enhancer(FULLSUBNET_PLUS, model.config, model.state_dict(), device="cpu",
                    **ACOUSTICS, **kw)


def test_enhancer_padded_batch_matches_exact_on_a_masked_variant():
    """CBAM's masked mean and max with the offline Gaussian norm: a padded
    batch's short row matches its exact-length run."""
    enhancer = _enhancer(dict(channel_attention_model="CBAM", norm_type="offline_gaussian_norm"))
    rng = np.random.default_rng(9)
    padded = (0.1 * rng.standard_normal((2, 800))).astype(np.float32)
    padded[0, 500:] = 0.0
    masked = enhancer.enhance_batch(padded, lengths=[500, 800])
    exact = enhancer.enhance_batch(padded[:1, :500])[0]
    assert _snr(exact, masked[0, :500]) > 80.0


@pytest.mark.parametrize("name", ["DeepTSSE", "TSSE_ATT", "subband2_ECA"])
def test_enhancer_refuses_lengths_where_jax_does(name):
    enhancer = _enhancer(VARIANTS[name])
    noisy = np.zeros((2, 400), np.float32)
    assert enhancer.enhance_batch(noisy).shape == (2, 400)
    with pytest.raises(ValueError):
        enhancer.enhance_batch(noisy, lengths=[400, 300])


def test_enhancer_int8_quantizes_only_a_2_layer_lstm():
    """On int8 a GRU sub-band model runs in bfloat16 (nothing to quantize),
    as the JAX package runs it; an LSTM one is quantized."""
    gru_int8 = _enhancer(VARIANTS["GRU"], compute_dtype="int8")
    gru_bf16 = _enhancer(VARIANTS["GRU"], compute_dtype="bfloat16")
    assert gru_int8.model.sb_model.int8_weights is None
    noisy = (0.1 * np.random.default_rng(10).standard_normal((2, 400))).astype(np.float32)
    np.testing.assert_array_equal(gru_int8.enhance_batch(noisy), gru_bf16.enhance_batch(noisy))
    cbam = _enhancer(VARIANTS["CBAM"], compute_dtype="int8")
    assert cbam.model.sb_model.int8_weights is not None
    assert np.isfinite(cbam.enhance_batch(noisy)).all()
    assert gru_int8.model_config.quantized_lstm
