"""The port's checkpoints (io/checkpoint.py: CheckpointManager,
load_torch_checkpoint) against the JAX package's, on a tiny FullSubNet+ with
nonzero Adam moments: a JAX latest_model.npz resumes into the port's
TrainState bit for bit, the port's file resumes in JAX's CheckpointManager
bit for bit, the two write the same keys, dtypes, shapes and meta, `-P`
loads what a file holds and keeps the rest, and `--from-torch` reads a
reference .tar (written by JAX's save_torch_checkpoint) into the same
moments and count as JAX's load_torch_checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_torch.io import checkpoint, convert
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.train import step
from fullsubnet_plus_tpu.io import checkpoint as jcheckpoint
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.train import step as jstep

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(seed: int, count: int = 7, step_: int = 9):
    """A JAX TrainState with random Adam moments (nu > 0), count and step."""
    params = J_MODEL.init(jax.random.PRNGKey(seed), JConfig(**TINY))
    state = jstep.init_train_state(params, jstep.make_optimizer())
    rng = np.random.default_rng(seed)

    def rand(t, positive=False):
        x = rng.standard_normal(t.shape).astype(np.float32)
        return jnp.asarray(np.abs(x) if positive else x)

    def moments(adam):
        return type(adam)(count=jnp.asarray(count, jnp.int32),
                          mu=jax.tree_util.tree_map(rand, adam.mu),
                          nu=jax.tree_util.tree_map(lambda t: rand(t, True), adam.nu))

    opt_state = jcheckpoint._map_adam_states(state.opt_state, moments)
    return jstep.TrainState(params, opt_state, jnp.asarray(step_, jnp.int32))


def _port_dict(jax_state) -> dict:
    """A JAX TrainState -> the dict of the port's TrainState.state_dict()."""
    adam = jcheckpoint.find_adam_state(jax_state.opt_state)
    return convert.train_state_from_jax(_numpy(jax_state.params), _numpy(adam.mu),
                                        _numpy(adam.nu), adam.count, jax_state.step)


def _port_state(seed: int = 0):
    model = FULLSUBNET_PLUS.module_cls(FullSubNetPlusConfig(**TINY)).init_weights(
        torch.Generator().manual_seed(seed))
    return step.init_train_state(model, step.make_optimizer(), device="cpu")


def _assert_state_dicts_equal(got: dict, want: dict):
    assert got["count"] == want["count"] and got["step"] == want["step"]
    for key in ("params", "mu", "nu"):
        assert set(got[key]) == set(want[key])
        for name, value in want[key].items():
            assert got[key][name].dtype == torch.float32
            assert torch.equal(got[key][name], value), (key, name)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run's checkpoints/ (epoch 3, best) and the state it holds."""
    save_dir = str(tmp_path_factory.mktemp("jax_run"))
    state = _jax_state(1)
    jcheckpoint.CheckpointManager(save_dir, lr=1e-3).save(state, 3, 0.4, is_best=True)
    return save_dir, state


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's checkpoints/ (epoch 3, best) of a state with the same
    parameters and moments as `_jax_state(2)`, and that JAX state."""
    save_dir = str(tmp_path_factory.mktemp("port_run"))
    jax_state = _jax_state(2, count=11, step_=12)
    state = _port_state().load_state_dict(_port_dict(jax_state))
    checkpoint.CheckpointManager(save_dir, lr=1e-3).save(state, 3, 0.4, is_best=True)
    return save_dir, jax_state


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    save_dir, jax_state = jax_run
    manager = checkpoint.CheckpointManager(save_dir)
    assert os.path.exists(manager.latest_path)
    state, epoch, best = manager.resume(_port_state())
    assert (epoch, best) == (3, 0.4)
    _assert_state_dicts_equal(state.state_dict(), _port_dict(jax_state))


def test_port_checkpoint_resumes_in_jax(port_run):
    save_dir, jax_state = port_run
    template = _jax_state(5, count=0, step_=0)
    restored, epoch, best = jcheckpoint.CheckpointManager(save_dir).resume(template)
    assert (epoch, best) == (3, 0.4)
    got = jax.tree_util.tree_leaves_with_path(restored)
    want = jax.tree_util.tree_leaves_with_path(jax_state)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["latest_model.npz", "model_0003.npz", "best_model.npz"])
def test_checkpoint_keys_dtypes_and_meta_equal_jax(jax_run, port_run, name):
    ours, our_meta = checkpoint.load_flat(os.path.join(port_run[0], "checkpoints", name))
    theirs, their_meta = jcheckpoint.load_flat(os.path.join(jax_run[0], "checkpoints", name))
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype and ours[key].shape == value.shape, key
    assert our_meta == their_meta == {"epoch": 3, "best_score": 0.4, "lr": 0.001}


def test_preload_loads_what_the_file_holds(jax_run, tmp_path):
    save_dir, jax_state = jax_run
    want = convert.state_dict_from_jax(_numpy(jax_state.params))
    state = _port_state(seed=3)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    n = checkpoint.CheckpointManager.preload_params(
        os.path.join(save_dir, "checkpoints", "model_0003.npz"), state.model)
    assert n == len(want)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    # bare tree paths, without the sub-band model's: those keep their values
    flat = {k.removeprefix("params/"): v for k, v in
            checkpoint.load_flat(os.path.join(save_dir, "checkpoints", "model_0003.npz"))[0]
            .items() if "sb_model" not in k}
    checkpoint.save_flat(str(tmp_path / "partial.npz"), flat)
    state = _port_state(seed=3)
    n = checkpoint.CheckpointManager.preload_params(str(tmp_path / "partial.npz"), state.model)
    assert 0 < n < len(want)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, init[k] if k.startswith("sb_model.") else want[k]), k


def test_resume_rejects_an_incomplete_file(port_run, tmp_path):
    flat, meta = checkpoint.load_flat(os.path.join(port_run[0], "checkpoints",
                                                   "latest_model.npz"))
    flat.pop("opt_state/1/0/count")
    manager = checkpoint.CheckpointManager(str(tmp_path))
    checkpoint.save_flat(manager.latest_path, flat, meta)
    with pytest.raises(KeyError):
        manager.resume(_port_state())


@pytest.mark.parametrize("form", ["tar_with_adam", "tar_fresh", "pth"])
def test_from_torch_equals_jax(tmp_path, form):
    jax_state = _jax_state(4, count=13)
    path = str(tmp_path / ("ckpt.pth" if form == "pth" else "ckpt.tar"))
    jcheckpoint.save_torch_checkpoint(
        path, jax_state.params, epoch=5, best_score=0.25, lr=1e-3,
        opt_state=jax_state.opt_state if form == "tar_with_adam" else None)
    ours, meta = checkpoint.load_torch_checkpoint(path)
    params, opt_state, jmeta = jcheckpoint.load_torch_checkpoint(
        path, optimizer=jstep.make_optimizer())
    adam = jcheckpoint.find_adam_state(opt_state)
    want = convert.train_state_from_jax(_numpy(params), _numpy(adam.mu), _numpy(adam.nu),
                                        adam.count, adam.count)
    _assert_state_dicts_equal(ours, want)
    assert meta == jmeta == ({} if form == "pth" else {"epoch": 5, "best_score": 0.25})
    assert ours["count"] == (13 if form == "tar_with_adam" else 0)
    # and it loads into the port's TrainState
    state = _port_state().load_state_dict(ours)
    _assert_state_dicts_equal(state.state_dict(), want)
