"""The port's FullSubNet baseline (fullsubnet_plus_torch/models/fullsubnet.py)
against the JAX package's, on the CPU: the weight bridge both ways, the
forward tiny and at full width, with and without `valid_frames`, the int8
Enhancer, both eval steps, the streaming engine and the CLI. JAX runs at
HIGHEST matmul precision (its Pallas kernels through their plain
references, or in interpret mode for int8, as its own tests run them), the
port in float32 on the CPU, where the LSTMs take the plain versions of
their kernels.

Floors: the forward >= 80 dB (float32 sum order: measured about 140 dB
tiny), waveforms >= 60 dB, the eval losses to rtol 1e-4; the int8 Enhancer
>= 28 dB against JAX's int8 Enhancer, the floor the FullSubNet+ int8 test
holds (tests/test_torch_int8.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.io.torch_convert import export_fullsubnet
from fullsubnet_plus_tpu.models import FULLSUBNET as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet import FullSubNetConfig as JConfig
from fullsubnet_plus_tpu.serve import StreamingEngine as JStreamingEngine
from fullsubnet_plus_tpu.train import loss as jloss
from fullsubnet_plus_tpu.train import step as jstep
from fullsubnet_plus_torch.cli.enhance import run_enhance
from fullsubnet_plus_torch.data.wav import read_wav, write_wav
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io import checkpoint as tckpt
from fullsubnet_plus_torch.io.convert import (
    jax_from_state_dict,
    jax_from_train_state,
    key_table,
    state_dict_from_jax,
    train_state_from_jax,
)
from fullsubnet_plus_torch.models import FULLSUBNET, get_model
from fullsubnet_plus_torch.models.fullsubnet import FullSubNet, FullSubNetConfig
from fullsubnet_plus_torch.serve import StreamingEngine
from fullsubnet_plus_torch.train import loss, step

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side here is many small CPU ops (the plain LSTM loops);
    intra-op threads only add contention when test workers share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


@pytest.fixture(scope="module")
def full_params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(1)))


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / max(((ref - out) ** 2).sum(), 1e-300))


def _noisy(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# registry and weight bridge
# ---------------------------------------------------------------------------

def test_registry_names_and_config():
    assert get_model("fullsubnet") is FULLSUBNET
    assert get_model("fullsubnet.model.fullsubnet.Model") is FULLSUBNET
    assert FULLSUBNET.n_inputs == 1 and FULLSUBNET.module_cls is FullSubNet
    cfg = FULLSUBNET.make_config({"sb_num_neighbors": 15, "weight_init": False,
                                  "fb_model_hidden_size": 512})
    assert cfg == FullSubNetConfig()
    assert {f.name for f in dataclasses.fields(cfg)} == {f.name for f in dataclasses.fields(JConfig)}
    assert cfg.sb_input_size == JConfig().sb_input_size == 32


@pytest.mark.parametrize("which,kwargs", [("tiny_params", TINY), ("full_params", {})])
def test_bridge_matches_export_and_round_trips(request, which, kwargs):
    """state_dict_from_jax gives export_fullsubnet's keys, order and values,
    the module loads it strictly, and jax_from_state_dict returns the tree
    bit for bit; the model is read from the keys or given as `model=`."""
    params = request.getfixturevalue(which)
    ours, theirs = state_dict_from_jax(params), export_fullsubnet(params)
    assert list(ours) == list(theirs)
    assert state_dict_from_jax(params, model="fullsubnet").keys() == ours.keys()
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    model = FullSubNet(FullSubNetConfig(**kwargs))
    model.load_state_dict(ours, strict=True)
    assert list(model.state_dict()) == list(theirs)
    assert len(key_table(model="fullsubnet")) == len(theirs)
    back = jax_from_state_dict(model.state_dict())
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]  # noqa: E731
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (_, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, b)


def test_npz_checkpoint_round_trip(tmp_path, tiny_params):
    """A port-written .npz of FullSubNet loads back into the JAX tree and
    into the module, strict."""
    model = FullSubNet(FullSubNetConfig(**TINY)).load_jax_params(tiny_params)
    path = str(tmp_path / "fsn.npz")
    tckpt.save_flat(path, {"params": jax_from_state_dict(model.state_dict())}, {"epoch": 0})
    again = FullSubNet(FullSubNetConfig(**TINY))
    again.load_state_dict(state_dict_from_jax(tckpt.load_jax_params(path)), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_train_state_bridge_round_trips(tiny_params):
    """The train-state pair carries FullSubNet's parameters and Adam moments
    (same key table and transposes) both ways, bit for bit."""
    rng = np.random.default_rng(2)
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                tiny_params)
    nu = jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), tiny_params)
    state = train_state_from_jax(tiny_params, mu, nu, 3, 5)
    assert state["count"] == 3 and state["step"] == 5
    assert list(state["mu"]) == list(export_fullsubnet(tiny_params))
    back = jax_from_train_state(state)
    for name, tree in (("params", tiny_params), ("mu", mu), ("nu", nu)):
        for a, b in zip(jax.tree_util.tree_leaves(back[name]), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,kwargs,shape", [("tiny_params", TINY, (2, 1, 33, 20)),
                                                ("full_params", {}, (1, 1, 257, 24))])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(request, which, kwargs, shape, masked):
    params = request.getfixturevalue(which)
    mag = np.abs(np.random.default_rng(3).standard_normal(shape)).astype(np.float32)
    valid = np.asarray([shape[-1] - 7, shape[-1]][:shape[0]], np.int32) if masked else None
    kw = {} if valid is None else {"valid_frames": jnp.asarray(valid)}
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_MODEL.apply(params, jnp.asarray(mag), JConfig(**kwargs), **kw))
    model = FullSubNet(FullSubNetConfig(**kwargs)).load_jax_params(params)
    with torch.no_grad():
        out = model(torch.from_numpy(mag), valid_frames=None if valid is None
                    else torch.from_numpy(valid).long()).numpy()
    assert out.shape == ref.shape == (shape[0], 2, shape[2], shape[3])
    assert _snr(ref, out) >= 80.0, _snr(ref, out)


def test_training_forward_matches_jax(tiny_params):
    """training=True: drop_band on the sub-band input, through the
    differentiable LSTM route, against JAX's training forward."""
    mag = np.abs(np.random.default_rng(4).standard_normal((4, 1, 33, 12))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_MODEL.apply(tiny_params, jnp.asarray(mag), JConfig(**TINY),
                                       training=True))
    model = FullSubNet(FullSubNetConfig(**TINY)).load_jax_params(tiny_params)
    out = model(torch.from_numpy(mag), training=True)
    assert out.requires_grad and tuple(out.shape) == ref.shape == (4, 2, 16, 12)
    assert _snr(ref, out.detach().numpy()) >= 80.0
    with pytest.raises(ValueError, match="serving-path"):
        model(torch.from_numpy(mag), training=True, valid_frames=torch.tensor([12] * 4))


def test_prepare_int8_prepares_both_lstms(tiny_params):
    model = FullSubNet(FullSubNetConfig(**TINY, quantized_lstm=True)).load_jax_params(
        tiny_params).to(torch.bfloat16).prepare_int8()
    for seq in (model.fb_model, model.sb_model):
        assert seq.int8_weights is not None and seq.int8_weights.u1q.dtype == torch.int8
    assert model.fb_model.int8_weights.fc_w.shape == (16, 33)


# ---------------------------------------------------------------------------
# the Enhancer, the CLI and the engine on FullSubNet
# ---------------------------------------------------------------------------

def _port(params, **kw):
    return Enhancer(FULLSUBNET, FullSubNetConfig(**TINY), state_dict_from_jax(params),
                    inference_type="full_band_crm_mask", device="cpu", **ACOUSTICS, **kw)


def _jax(params, **kw):
    return JEnhancer(J_MODEL, JConfig(**TINY), params, inference_type="full_band_crm_mask",
                     **ACOUSTICS, **kw)


def test_int8_enhancer_matches_jax_int8(tiny_params, monkeypatch):
    """The int8 FullSubNet (both LSTMs quantized, as the JAX Enhancer's
    `_attach_int8_prepared` does) against the JAX int8 Enhancer, whose
    kernels run in interpret mode, on a length-masked batch."""
    import fullsubnet_plus_tpu.nn.sequence as jseq

    monkeypatch.setattr(jseq, "FORCE_PALLAS_INTERPRET", True)
    noisy = _noisy((2, 4000), 5)
    ref = _jax(tiny_params, compute_dtype="int8").enhance_batch(noisy, lengths=[3000, 4000])
    e = _port(tiny_params, compute_dtype="int8")
    assert e.model.config.quantized_lstm and e.dtype == torch.bfloat16
    assert e.model.fb_model.int8_weights is not None and e.model.sb_model.int8_weights is not None
    out = e.enhance_batch(noisy, lengths=[3000, 4000])
    assert np.isfinite(out).all()
    assert _snr(ref, out) >= 28.0, _snr(ref, out)


def test_run_enhance_fullsubnet_toml_end_to_end(tmp_path, tiny_params):
    """A FullSubNet config (type full_band_crm_mask, n_neighbor and
    [inferencer.args] read) and a JAX-format .npz in, rescaled wavs of the
    same length out, each matching the Enhancer's exact-length run."""
    rng = np.random.default_rng(6)
    lengths = [2600, 4000, 5100]
    for i, n in enumerate(lengths):
        write_wav(str(tmp_path / "noisy" / f"utt{i}.wav"),
                  (0.2 * rng.standard_normal(n)).astype(np.float32), 16000)
    tckpt.save_flat(str(tmp_path / "model.npz"), {"params": tiny_params}, {"epoch": 0})
    config = {
        "acoustics": {**ACOUSTICS, "sr": 16000},
        "inferencer": {"type": "full_band_crm_mask", "args": {"n_neighbor": 4}},
        "model": {"path": "fullsubnet.model.fullsubnet.Model", "args": TINY},
    }
    stats = run_enhance(config, str(tmp_path / "model.npz"), str(tmp_path / "out"),
                        input_dirs=[str(tmp_path / "noisy")], batch_size=2, device="cpu")
    assert stats["files"] == 3
    e = _port(tiny_params)
    assert e.n_neighbor == 15  # the Enhancer's own default; the CLI passed the config's
    for i, n in enumerate(lengths):
        y = read_wav(str(tmp_path / "out" / f"utt{i}.wav"))
        assert y.shape == (n,) and np.isfinite(y).all()
        exact = e.enhance(read_wav(str(tmp_path / "noisy" / f"utt{i}.wav")))
        assert _snr(exact, y) > 35.0  # int16 wav quantization bounds it


def test_engine_matches_jax_engine(tiny_params):
    """The streaming engine serves a one-view model through
    full_band_crm_mask; two streams through the JAX engine and the port's,
    float32, the same weights: >= 60 dB."""
    acoustics = {**ACOUSTICS, "sr": 1000}
    jenhancer = JEnhancer(J_MODEL, JConfig(**TINY), tiny_params, **acoustics)
    enhancer = Enhancer(FULLSUBNET, FullSubNetConfig(**TINY), state_dict_from_jax(tiny_params),
                        device="cpu", **acoustics)
    utts = [_noisy(9000, 1), _noisy(5300, 2)]
    outs = []
    for engine in (JStreamingEngine(jenhancer, slots=2, chunk_samples=4000),
                   StreamingEngine(enhancer, slots=2, chunk_samples=4000)):
        assert engine.mode == "full_band_crm_mask"
        sids = [engine.open() for _ in utts]
        for sid, y in zip(sids, utts):
            engine.feed(sid, y)
            engine.close(sid)
        with jax.default_matmul_precision("highest"):
            engine.drain()
        outs.append([engine.pull(sid) for sid in sids])
    for ref, out, y in zip(*outs, utts):
        assert out.shape == ref.shape == y.shape
        assert _snr(ref, out) >= 60.0, _snr(ref, out)


# ---------------------------------------------------------------------------
# the train and eval steps
# ---------------------------------------------------------------------------

def _pair(batch, samples, seed):
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((batch, samples))).astype(np.float32)
    return (clean + 0.1 * rng.standard_normal((batch, samples))).astype(np.float32), clean


def test_eval_step_matches_jax(tiny_params):
    noisy, clean = _pair(2, 1024, 7)
    with jax.default_matmul_precision("highest"):
        jeval = jstep.make_eval_step(J_MODEL, JConfig(**TINY), jloss.get_loss("mse_loss"),
                                     **ACOUSTICS)
        ref_loss, ref_wave = jeval(tiny_params, jnp.asarray(noisy), jnp.asarray(clean))
    model = FullSubNet(FullSubNetConfig(**TINY)).load_jax_params(tiny_params)
    ev = step.make_eval_step(FULLSUBNET, FullSubNetConfig(**TINY), loss.get_loss("mse_loss"),
                             device="cpu", **ACOUSTICS)
    out_loss, out_wave = ev(model, noisy, clean)
    np.testing.assert_allclose(float(out_loss), float(ref_loss), rtol=1e-4)
    assert _snr(np.asarray(ref_wave), out_wave.numpy()) >= 60.0


def test_bucketed_eval_step_matches_jax_and_exact_length(tiny_params):
    """Length-masked validation on a bucket-padded batch against JAX's, and
    each row against the exact-length eval step."""
    noisy, clean = _pair(2, 1600, 8)
    lengths = np.asarray([1100, 1600])
    noisy[0, 1100:] = clean[0, 1100:] = 0.0
    with jax.default_matmul_precision("highest"):
        jeval = jstep.make_bucketed_eval_step(J_MODEL, JConfig(**TINY),
                                              jloss.get_loss("mse_loss"), **ACOUSTICS)
        ref_losses, ref_wave = jeval(tiny_params, jnp.asarray(noisy), jnp.asarray(clean),
                                     jnp.asarray(lengths, jnp.int32))
    model = FullSubNet(FullSubNetConfig(**TINY)).load_jax_params(tiny_params)
    kw = dict(device="cpu", **ACOUSTICS)
    ev = step.make_bucketed_eval_step(FULLSUBNET, FullSubNetConfig(**TINY),
                                      loss.get_loss("mse_loss"), **kw)
    losses, wave = ev(model, noisy, clean, lengths)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-4)
    assert _snr(np.asarray(ref_wave), wave.numpy()) >= 60.0
    exact = step.make_eval_step(FULLSUBNET, FullSubNetConfig(**TINY), loss.get_loss("mse_loss"),
                                **kw)
    for i, n in enumerate(lengths):
        e_loss, e_wave = exact(model, noisy[i:i + 1, :n], clean[i:i + 1, :n])
        np.testing.assert_allclose(float(losses[i]), float(e_loss), rtol=1e-4)
        assert _snr(e_wave.numpy()[0], wave.numpy()[i, :n]) > 80.0


def test_train_step_refuses_fullsubnet():
    """FullSubNet's training step waits for the reverse sweep at the
    full-band shape (D 257, H 512), named in its error."""
    with pytest.raises(NotImplementedError, match="Queue 2 R6, the reverse sweep at the fb_model"):
        step.make_train_step(FULLSUBNET, FullSubNetConfig(**TINY), step.make_optimizer(),
                             loss.get_loss("mse_loss"), device="cpu", **ACOUSTICS)

