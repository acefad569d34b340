"""The port's training slice (dsp/mask.py, dsp/unfold.py, the model with
training=True, train/loss.py, train/step.py, the state bridge of
io/convert.py) against the JAX package's, on the CPU at a tiny config
(n_fft 64, hidden 16, batch 4): the same JAX-initialized weights and numpy
waveforms, JAX at HIGHEST matmul precision, the port in float32 with
device="cpu" (where the sub-band LSTM takes the plain versions of its
kernels).

Tolerances of the Adam trajectory (5 steps, lr 1e-3): loss rtol 1e-4 and
gradient norm rtol 1e-3 per step (float32 sum order); final parameters
max-abs <= 2.5e-3 with at least 99 % of the elements within 1e-4. Early
Adam steps move every element by about lr * g / |g|, so an element whose
gradient is round-off noise may take its lr-sized step in either direction;
the JAX package's own step test holds parameters to atol 1e-3 after 3 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fullsubnet_plus_tpu.nn.sequence as jseq
from fullsubnet_plus_tpu.dsp import mask as jmask
from fullsubnet_plus_tpu.dsp import unfold as junfold
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.train import loss as jloss
from fullsubnet_plus_tpu.train import step as jstep
from fullsubnet_plus_torch.dsp import mask, unfold
from fullsubnet_plus_torch.io.convert import (
    jax_from_train_state,
    state_dict_from_jax,
    train_state_from_jax,
)
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS, get_model
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.parallel import make_mesh
from fullsubnet_plus_torch.train import loss, step

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)
BATCH, SAMPLES, STEPS = 4, 1024, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side here is thousands of tiny CPU ops (the plain LSTM
    loops); intra-op threads only add contention when several test workers
    share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-300))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    return _numpy_tree(J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


def _model(params):
    return FULLSUBNET_PLUS.module_cls(FullSubNetPlusConfig(**TINY)).load_jax_params(params)


def _batches(count=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        clean = (0.1 * rng.standard_normal((BATCH, SAMPLES))).astype(np.float32)
        out.append((clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32), clean))
    return out


# ---------------------------------------------------------------------------
# dsp
# ---------------------------------------------------------------------------

def test_compress_cirm_matches_jax_and_clamps(rng):
    x = np.concatenate([rng.standard_normal(200) * 30, [-100.0, -150.0, -1e6, 0.0, 99.0]])
    x = x.astype(np.float32)
    out = mask.compress_cirm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jmask.compress_cirm(jnp.asarray(x))), atol=1e-5)
    assert out[-4] == out[-5] == out[-3]  # everything <= -100 compresses as -100
    assert np.isfinite(out).all()


def test_build_cirm_matches_jax(rng):
    views = [rng.standard_normal((2, 33, 20)).astype(np.float32) for _ in range(4)]
    views[0][0, :3] = 0.0  # silent noisy bins: the EPSILON guard
    views[1][0, :3] = 0.0
    ref = np.asarray(jmask.build_complex_ideal_ratio_mask(*map(jnp.asarray, views)))
    out = mask.build_complex_ideal_ratio_mask(*map(torch.tensor, views)).numpy()
    assert out.shape == (2, 33, 20, 2)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch,freqs,groups", [(4, 33, 2), (6, 257, 2), (7, 33, 3), (3, 10, 1)])
def test_drop_band_index_order_matches_jax(batch, freqs, groups):
    """Exact: every element is a distinct number, so the order is held."""
    x = np.arange(batch * 2 * freqs * 3, dtype=np.float32).reshape(batch, 2, freqs, 3)
    ref = np.asarray(junfold.drop_band(jnp.asarray(x), groups))
    out = unfold.drop_band(torch.tensor(x), groups).numpy()
    assert out.shape == ref.shape == (batch, 2, freqs // groups if groups > 1 else freqs, 3)
    np.testing.assert_array_equal(out, ref)


def test_drop_band_needs_batch_above_groups():
    with pytest.raises(ValueError, match="must exceed num_groups"):
        unfold.drop_band(torch.zeros(2, 1, 8, 3), 2)


# ---------------------------------------------------------------------------
# model and losses
# ---------------------------------------------------------------------------

def test_model_training_forward_matches_jax(params, rng):
    views = [rng.standard_normal((BATCH, 1, 33, 40)).astype(np.float32) for _ in range(3)]
    views[0] = np.abs(views[0])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(J_MODEL.apply(params, *map(jnp.asarray, views), JConfig(**TINY),
                                       training=True))
    model = _model(params)
    out = model(*map(torch.tensor, views), training=True)
    assert out.requires_grad  # the differentiable route
    assert tuple(out.shape) == ref.shape == (BATCH, 2, 16, 40)
    assert _snr(ref, out.detach().numpy()) >= 80.0
    with pytest.raises(ValueError, match="serving-path"):
        model(*map(torch.tensor, views), training=True, valid_frames=torch.tensor([40] * BATCH))


@pytest.mark.parametrize("name", ["mse_loss", "l1_loss", "si_snr_loss"])
def test_losses_match_jax(rng, name):
    shape = (3, 500) if name == "si_snr_loss" else (2, 33, 20, 2)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    ref = float(jloss.get_loss(name)(jnp.asarray(a), jnp.asarray(b)))
    out = float(loss.get_loss(name)(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_get_loss_and_get_model_reject_unknown():
    with pytest.raises(KeyError, match="Unknown loss"):
        loss.get_loss("nope")
    with pytest.raises(KeyError, match="Unknown model"):
        get_model("nope")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_adam(state):
    return state.opt_state[1][0]


def _jax_state(tree, optimizer):
    """A JAX TrainState from {"params", "mu", "nu", "count", "step"} numpy."""
    as_jnp = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = jstep.init_train_state(as_jnp(tree["params"]), optimizer)
    clip, (adam, tail) = state.opt_state
    adam = adam._replace(count=jnp.asarray(tree["count"], jnp.int32), mu=as_jnp(tree["mu"]),
                         nu=as_jnp(tree["nu"]))
    return jstep.TrainState(state.params, (clip, (adam, tail)),
                            jnp.asarray(tree["step"], jnp.int32))


_JAX_STEPS = {}  # the jitted JAX steps, compiled once per route


def _jax_train_step(route="scan"):
    """The JAX step; `route` only names the cache entry (the Pallas route is
    chosen by FORCE_PALLAS_INTERPRET when the step is first traced)."""
    if route not in _JAX_STEPS:
        _JAX_STEPS[route] = jstep.make_train_step(
            J_MODEL, JConfig(**TINY), jstep.make_optimizer(), jloss.mse_loss, **ACOUSTICS)
    return _JAX_STEPS[route]


def _jax_trajectory(start, batches, route="scan"):
    """(metrics per step, the state after every step as numpy)."""
    train_step = _jax_train_step(route)
    state, metrics, states = _jax_state(start, jstep.make_optimizer()), [], []
    with jax.default_matmul_precision("highest"):
        for noisy, clean in batches:
            state, m = train_step(state, noisy, clean)
            metrics.append({k: float(v) for k, v in m.items()})
            adam = _jax_adam(state)
            states.append({"params": _numpy_tree(state.params), "mu": _numpy_tree(adam.mu),
                           "nu": _numpy_tree(adam.nu), "count": int(adam.count),
                           "step": int(state.step)})
    return metrics, states


def _port_trajectory(start, batches, **kwargs):
    optimizer = step.make_optimizer()
    state = step.init_train_state(_model(start["params"]), optimizer, device="cpu")
    state.load_state_dict(train_state_from_jax(**start))
    train_step = step.make_train_step(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), optimizer,
                                      loss.mse_loss, device="cpu", **ACOUSTICS, **kwargs)
    metrics = []
    for noisy, clean in batches:
        state, m = train_step(state, noisy, clean)
        assert all(isinstance(v, torch.Tensor) for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _fresh(params):
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    return {"params": params, "mu": zeros, "nu": zeros, "count": 0, "step": 0}


def _assert_same_trajectory(port, ref):
    (m_port, state), (m_ref, states) = port, ref
    final = states[-1]
    for a, b in zip(m_port, m_ref):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-3)
        assert a["skipped"] == b["skipped"] == 0.0
    assert int(state.step) == final["step"] and int(state.opt_state.count) == final["count"]
    want = state_dict_from_jax(final["params"])
    diffs = np.concatenate([(p.detach() - want[k]).abs().numpy().ravel()
                            for k, p in state.model.state_dict().items()])
    assert diffs.max() <= 2.5e-3, diffs.max()
    assert (diffs <= 1e-4).mean() >= 0.99, (diffs <= 1e-4).mean()


@pytest.fixture(scope="module")
def jax_scan_run(params):
    return _jax_trajectory(_fresh(params), _batches())


def test_adam_trajectory_matches_jax_scan_path(params, jax_scan_run):
    _assert_same_trajectory(_port_trajectory(_fresh(params), _batches()), jax_scan_run)


def test_adam_trajectory_matches_jax_pallas_interpret(params, monkeypatch):
    """The JAX step through its TPU kernels in interpret mode (K2 and the
    fused-wgrad backward), the route the port's kernels replace."""
    monkeypatch.setattr(jseq, "FORCE_PALLAS_INTERPRET", True)
    ref = _jax_trajectory(_fresh(params), _batches(2), route="pallas_interpret")
    _assert_same_trajectory(_port_trajectory(_fresh(params), _batches(2)), ref)


def test_trajectory_from_a_carried_mid_run_state(jax_scan_run):
    """Both packages start from the JAX run's state after 5 steps (moments
    and counts carried across by io/convert.py) and take 2 more steps."""
    mid = jax_scan_run[1][-1]
    assert mid["count"] == mid["step"] == STEPS
    later = _batches(2, seed=1)
    _assert_same_trajectory(_port_trajectory(mid, later), _jax_trajectory(mid, later))


def test_train_state_round_trip(jax_scan_run):
    mid = jax_scan_run[1][-1]
    state = step.init_train_state(_model(mid["params"]), step.make_optimizer(), device="cpu")
    state.load_state_dict(train_state_from_jax(**mid))
    back = jax_from_train_state(state.state_dict())
    assert back["count"] == mid["count"] and back["step"] == mid["step"]
    for key in ("params", "mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(back[key]),
                        jax.tree_util.tree_leaves(mid[key])):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError, match="mu keys"):
        state.load_state_dict({**state.state_dict(), "mu": {}})


def test_nan_batch_is_skipped_like_jax(params):
    """A NaN in the noisy batch: parameters and moments unchanged bit for
    bit, Adam's count unchanged, `skipped` 1.0, the step advanced; the JAX
    step does the same."""
    (noisy, clean), (bad, _) = _batches(2)
    bad = bad.copy()
    bad[1, 100] = np.nan
    batches = [(noisy, clean), (bad, clean)]
    m_ref, (after_one, final) = _jax_trajectory(_fresh(params), batches)
    m_port, state = _port_trajectory(_fresh(params), batches[:1])
    before = state.state_dict()
    _, m = step.make_train_step(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY),
                                step.make_optimizer(), loss.mse_loss, device="cpu",
                                **ACOUSTICS)(state, bad, clean)
    after = state.state_dict()
    assert float(m["skipped"]) == m_ref[1]["skipped"] == 1.0
    assert not np.isfinite(float(m["loss"]))
    assert after["step"] == final["step"] == 2 and after["count"] == final["count"] == 1
    for key in ("params", "mu", "nu"):
        for name in before[key]:
            assert torch.equal(before[key][name], after[key][name]), (key, name)
        for a, b in zip(jax.tree_util.tree_leaves(final[key]),
                        jax.tree_util.tree_leaves(after_one[key])):
            np.testing.assert_array_equal(a, b)  # JAX kept its state too


def test_bf16_and_remat_keep_float32_masters(params):
    """compute_dtype bf16 and remat=True run, keep float32 parameters and
    moments, and give the float32 step's loss: remat rtol 1e-5 (the same
    arithmetic, recomputed), bf16 rtol 0.1 (the JAX package's own bounds,
    tests/test_train.py::test_train_step_bf16_and_remat)."""
    batch = _batches(1)
    losses = {}
    for name, kwargs in (("fp32", {}), ("bf16", {"compute_dtype": torch.bfloat16}),
                         ("remat", {"remat": True})):
        metrics, state = _port_trajectory(_fresh(params), batch, **kwargs)
        losses[name] = metrics[0]["loss"]
        assert metrics[0]["skipped"] == 0.0 and np.isfinite(metrics[0]["grad_norm"])
        tensors = [*state.model.parameters(), state.opt_state.mu, state.opt_state.nu]
        assert all(t.dtype == torch.float32 for t in tensors)
        assert float(state.opt_state.mu.abs().max()) > 0
    np.testing.assert_allclose(losses["remat"], losses["fp32"], rtol=1e-5)
    np.testing.assert_allclose(losses["bf16"], losses["fp32"], rtol=0.1)


def test_steps_refuse_what_is_not_ported_and_a_missing_card():
    config, optimizer = FullSubNetPlusConfig(**TINY), step.make_optimizer()
    # a malformed mesh raises; a batch that does not divide over a mesh's 'data'
    # cards raises at the step (the mesh itself works: tests/test_torch_mesh_train.py,
    # test_torch_parallel.py, test_torch_multiprocess.py)
    with pytest.raises(TypeError, match="Mesh"):
        step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss, mesh=object(),
                             device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        step.make_bucketed_eval_step(FULLSUBNET_PLUS, config, loss.mse_loss, mesh=object(),
                                     device="cpu")
    meshed = step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss,
                                  mesh=make_mesh(2, 2, devices=["cpu"] * 4), **ACOUSTICS)
    state = step.init_train_state(FULLSUBNET_PLUS.module_cls(config), optimizer, device="cpu")
    with pytest.raises(ValueError, match="does not divide over the 2 'data' card"):
        meshed(state, np.zeros((3, 1024), np.float32), np.zeros((3, 1024), np.float32))
    if not torch.cuda.is_available():  # the default device is the card
        for make in (lambda: step.make_train_step(FULLSUBNET_PLUS, config, optimizer,
                                                  loss.mse_loss),
                     lambda: step.make_eval_step(FULLSUBNET_PLUS, config, loss.mse_loss),
                     lambda: step.make_bucketed_eval_step(FULLSUBNET_PLUS, config,
                                                          loss.mse_loss)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()


def test_float32_step_on_the_card_refuses_tf32(monkeypatch):
    """A float32 step for the card refuses TF32 matmuls when built and when
    run (the flag may be set later); bf16 and the CPU are unaffected."""
    config, optimizer = FullSubNetPlusConfig(**TINY), step.make_optimizer()
    monkeypatch.setattr(step, "resolve_device", lambda device: torch.device(device))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss, device="cuda")
    step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss, device="cuda",
                         compute_dtype=torch.bfloat16)
    cpu_step = step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss,
                                    device="cpu", **ACOUSTICS)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    card_step = step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss,
                                     device="cuda", **ACOUSTICS)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    state = step.init_train_state(
        FULLSUBNET_PLUS.module_cls(config).init_weights(torch.Generator().manual_seed(0)),
        optimizer,
        device="cpu")
    noisy, clean = _batches(1)[0]
    cpu_step(state, noisy, clean)  # the CPU has no TF32
    with pytest.raises(RuntimeError, match="allow_tf32"):
        card_step(state, noisy, clean)


# ---------------------------------------------------------------------------
# the evaluation steps
# ---------------------------------------------------------------------------

def test_eval_step_matches_jax(params):
    noisy, clean = _batches(1, seed=2)[0]
    with jax.default_matmul_precision("highest"):
        ref_loss, ref_wave = jstep.make_eval_step(J_MODEL, JConfig(**TINY), jloss.mse_loss,
                                                  **ACOUSTICS)(params, noisy, clean)
    eval_step = step.make_eval_step(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY),
                                    loss.mse_loss, device="cpu", **ACOUSTICS)
    out_loss, out_wave = eval_step(_model(params), noisy, clean)
    np.testing.assert_allclose(float(out_loss), float(ref_loss), rtol=1e-4)
    assert tuple(out_wave.shape) == noisy.shape
    assert _snr(np.asarray(ref_wave), out_wave.numpy()) >= 60.0


def test_bucketed_eval_step_matches_jax_and_exact_length_runs(params):
    """Rows of a bucket-padded batch against the JAX bucketed step, and each
    row against the exact-length batch-1 `make_eval_step` (>= 80 dB)."""
    noisy, clean = _batches(1, seed=3)[0]
    lengths = np.array([SAMPLES, 750, 555, 1000])
    for row, n in enumerate(lengths):
        noisy[row, n:] = 0.0
        clean[row, n:] = 0.0
    with jax.default_matmul_precision("highest"):
        ref_losses, ref_wave = jstep.make_bucketed_eval_step(
            J_MODEL, JConfig(**TINY), jloss.mse_loss, **ACOUSTICS)(
                params, noisy, clean, jnp.asarray(lengths, jnp.int32))
    config, model = FullSubNetPlusConfig(**TINY), _model(params)
    bucketed = step.make_bucketed_eval_step(FULLSUBNET_PLUS, config, loss.mse_loss,
                                            device="cpu", **ACOUSTICS)
    exact = step.make_eval_step(FULLSUBNET_PLUS, config, loss.mse_loss, device="cpu",
                                **ACOUSTICS)
    losses, wave = bucketed(model, noisy, clean, lengths)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses), rtol=1e-4)
    for row, n in enumerate(lengths):
        assert _snr(np.asarray(ref_wave)[row, :n], wave[row, :n].numpy()) >= 60.0
        one_loss, one_wave = exact(model, noisy[row:row + 1, :n], clean[row:row + 1, :n])
        np.testing.assert_allclose(float(losses[row]), float(one_loss), rtol=1e-4)
        assert _snr(one_wave[0].numpy(), wave[row, :n].numpy()) >= 80.0
