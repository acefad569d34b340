"""Training on a mesh of several cards in one process, on the CPU: the
batch over the local 'data' cards and the sub-band fold over 'freq', with
a backward (a CPU mesh names the CPU once a card; the kernels' plain
versions run).

  * The port's `make_train_step(mesh=)` on meshes (2, 1), (1, 2) and
    (2, 2) with `fold_sharding` ("data", "freq"), and FullSubNet on (2, 1),
    against JAX's mesh step on conftest's fake CPU devices over TRAIN_STEPS
    float32 Adam steps from the same weights: loss within rtol 1e-4 and
    gradient norm within 1e-3 at every step, then every parameter within
    2.5e-3 and 99 % of them within 1e-4 (tests/test_torch_fullsubnet.py's
    trajectory tolerances). A batch of 6 puts the second 'data' card's
    first row at the odd global row 3, so `drop_band` sees a card's offset.
  * The same meshes against the port's step without a mesh from the same
    state: loss within rtol 1e-5 and gradient norm within 1e-4 (JAX's own
    bounds, tests/test_parallel.py), and the parameters bit-equal over a
    repeat of the mesh run.
  * `lstm2_fc_train_split` against `lstm2_fc_train` unsplit, and a fold
    that does not divide.
  * `Trainer(mesh=)` on a (2, 1) mesh against the Trainer without one, and
    the training CLI's choice of cards.

The JAX steps compile in threads at once (each compile takes seconds).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.models import FULLSUBNET as J_FSN
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet import FullSubNetConfig as JFConfig
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.parallel import make_mesh as j_make_mesh
from fullsubnet_plus_tpu.parallel import replicated as j_replicated
from fullsubnet_plus_tpu.train import loss as jloss
from fullsubnet_plus_tpu.train import step as jstep
from fullsubnet_plus_torch.cli.train import mesh_devices
from fullsubnet_plus_torch.io.convert import jax_from_state_dict, state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET, FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet import FullSubNetConfig
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.ops import lstm2_train
from fullsubnet_plus_torch.parallel import mesh as pmesh
from fullsubnet_plus_torch.train import loss, step
from fullsubnet_plus_torch.train.trainer import Trainer

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)
FOLD = ("data", "freq")
MESHES = [(2, 1), (1, 2), (2, 2)]
ROWS, SAMPLES, TRAIN_STEPS = 6, 1024, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    clean = (0.3 * rng.standard_normal((rows, SAMPLES))).astype(np.float32)
    return (clean + 0.1 * rng.standard_normal((rows, SAMPLES))).astype(np.float32), clean


BATCHES = [_pair(30 + i) for i in range(TRAIN_STEPS)]


def cpu_mesh(data, freq=1):
    return pmesh.make_mesh(data, freq, devices=["cpu"] * (data * freq))


def _port_params(model_def, config, seed):
    """A seeded tree of the port's init in the JAX package's layout (the
    JAX init's op-by-op draws cost seconds a tree)."""
    model = model_def.module_cls(config).init_weights(torch.Generator().manual_seed(seed))
    return jax_from_state_dict(model.state_dict(), model=model_def.name)


@pytest.fixture(scope="module")
def weights():
    return {"fullsubnet_plus": _port_params(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), 0),
            "fullsubnet": _port_params(FULLSUBNET, FullSubNetConfig(**TINY), 1)}


@pytest.fixture(scope="module")
def jax_runs(weights):
    """{(model, data, freq): (metrics per step, final parameters as numpy)}
    of JAX's mesh step over BATCHES, the four meshes compiled in threads."""

    def run(case):
        name, data, freq = case
        j_model, config = ((J_MODEL, JConfig(**TINY, fold_sharding=FOLD))
                           if name == "fullsubnet_plus" else (J_FSN, JFConfig(**TINY)))
        mesh, optimizer = j_make_mesh(data, freq), jstep.make_optimizer()
        train_step = jstep.make_train_step(j_model, config, optimizer, jloss.mse_loss,
                                           mesh=mesh, **ACOUSTICS)
        state = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, weights[name]),
                                       optimizer)
        state, metrics = jax.device_put(state, j_replicated(mesh)), []
        with jax.default_matmul_precision("highest"):
            for noisy, clean in BATCHES:
                state, m = train_step(state, noisy, clean)
                metrics.append({k: float(v) for k, v in m.items()})
        return metrics, jax.tree_util.tree_map(np.asarray, state.params)

    cases = [("fullsubnet_plus", *shape) for shape in MESHES] + [("fullsubnet", 2, 1)]
    with ThreadPoolExecutor(len(cases)) as pool:
        return dict(zip(cases, pool.map(run, cases)))


def _model(name, weights, fold=FOLD):
    if name == "fullsubnet_plus":
        model_def, config = FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY, fold_sharding=fold)
    else:
        model_def, config = FULLSUBNET, FullSubNetConfig(**TINY)
    return model_def, config, model_def.module_cls(config).load_jax_params(weights[name])


def _port_run(name, weights, mesh):
    """(metrics per step, state) of the port's step over BATCHES from
    `weights`, on `mesh` or without one."""
    model_def, config, model = _model(name, weights)
    optimizer = step.make_optimizer()
    state = step.init_train_state(model, optimizer, device="cpu")
    train_step = step.make_train_step(model_def, config, optimizer, loss.mse_loss, mesh=mesh,
                                      device="cpu", **ACOUSTICS)
    metrics = [{k: float(v) for k, v in train_step(state, noisy, clean)[1].items()}
               for noisy, clean in BATCHES]
    return metrics, state


def _assert_matches_jax(name, metrics, state, ref):
    ref_metrics, ref_params = ref
    for m, r in zip(metrics, ref_metrics):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=1e-3)
        assert m["skipped"] == r["skipped"] == 0.0
    assert int(state.step) == int(state.opt_state.count) == TRAIN_STEPS
    want = state_dict_from_jax(ref_params, model=name)
    diffs = np.concatenate([(p.detach() - want[k]).abs().numpy().ravel()
                            for k, p in state.model.state_dict().items()])
    assert diffs.max() <= 2.5e-3, diffs.max()
    assert (diffs <= 1e-4).mean() >= 0.99, (diffs <= 1e-4).mean()


@pytest.mark.parametrize("data,freq", MESHES, ids=[f"{d}x{f}" for d, f in MESHES])
def test_mesh_step_matches_jax_mesh_step(weights, jax_runs, data, freq):
    metrics, state = _port_run("fullsubnet_plus", weights, cpu_mesh(data, freq))
    _assert_matches_jax("fullsubnet_plus", metrics, state,
                        jax_runs[("fullsubnet_plus", data, freq)])


def test_fullsubnet_mesh_step_matches_jax_mesh_step(weights, jax_runs):
    """FullSubNet has no fold_sharding: the 'data' split alone, both its
    LSTMs through the differentiable function on each card."""
    metrics, state = _port_run("fullsubnet", weights, cpu_mesh(2))
    _assert_matches_jax("fullsubnet", metrics, state, jax_runs[("fullsubnet", 2, 1)])


@pytest.fixture(scope="module")
def one_card_run(weights):
    return _port_run("fullsubnet_plus", weights, None)[0]


@pytest.mark.parametrize("data,freq", MESHES, ids=[f"{d}x{f}" for d, f in MESHES])
def test_mesh_step_matches_one_card_step_and_repeats_bit_for_bit(weights, one_card_run, data,
                                                                 freq):
    one = one_card_run
    runs = [_port_run("fullsubnet_plus", weights, cpu_mesh(data, freq)) for _ in range(2)]
    for m, r in zip(runs[0][0], one):
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=1e-4)
    assert runs[0][0] == runs[1][0]
    for a, b in zip(*(run[1].model.parameters() for run in runs)):
        assert torch.equal(a, b)


def test_mesh_step_splits_the_fold_on_each_data_card(weights):
    """A (2, 2) mesh: the state's model sweeps its fold over its 'freq'
    row; a batch that does not divide over the 'data' cards raises."""
    model_def, config, model = _model("fullsubnet_plus", weights)
    optimizer = step.make_optimizer()
    state = step.init_train_state(model, optimizer, device="cpu")
    train_step = step.make_train_step(model_def, config, optimizer, loss.mse_loss,
                                      mesh=cpu_mesh(2, 2), **ACOUSTICS)
    _, m = train_step(state, *BATCHES[0])
    assert np.isfinite(float(m["loss"])) and float(m["skipped"]) == 0.0
    assert state.model.sb_model.fold_devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="does not divide"):
        train_step(state, BATCHES[0][0][:3], BATCHES[0][1][:3])


def _lstm_args(n=12, d_in=6, hidden=16, out_dim=3, steps=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d_in, steps, generator=g, dtype=torch.float64).requires_grad_()
    shapes = [(4 * hidden, d_in), (4 * hidden, hidden), (4 * hidden,), (4 * hidden,),
              (4 * hidden, hidden), (4 * hidden, hidden), (4 * hidden,), (4 * hidden,),
              (out_dim, hidden), (out_dim,)]
    params = [(0.3 * torch.randn(s, generator=g, dtype=torch.float64)).requires_grad_()
              for s in shapes]
    dy = torch.randn(n, steps, out_dim, generator=g, dtype=torch.float64)
    return x, params, dy


def _grads(fn, x, params, dy):
    y = fn(x, params)
    return y.detach(), torch.autograd.grad(y, [x, *params], dy)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("parts", [2, 3])
def test_fold_split_train_matches_unsplit(parts):
    """The output within 1e-6 relative and all eleven gradients (dx and
    the ten parameters', summed over the cards) within 1e-5 relative."""
    x, params, dy = _lstm_args()
    y_ref, g_ref = _grads(lambda x, p: lstm2_train.lstm2_fc_train(x, *p), x, params, dy)
    y, g = _grads(lambda x, p: lstm2_train.lstm2_fc_train_split(x, p, ["cpu"] * parts),
                  x, params, dy)
    assert _rel(y, y_ref) <= 1e-6
    assert len(g) == 11 and max(_rel(a, b) for a, b in zip(g, g_ref)) <= 1e-5


def test_fold_split_train_that_does_not_divide_warns_and_runs_whole():
    x, params, dy = _lstm_args(n=7)
    y_ref, g_ref = _grads(lambda x, p: lstm2_train.lstm2_fc_train(x, *p), x, params, dy)
    with pytest.warns(UserWarning, match="does not divide"):
        y, g = _grads(lambda x, p: lstm2_train.lstm2_fc_train_split(x, p, ["cpu"] * 2),
                      x, params, dy)
    assert torch.equal(y, y_ref) and all(torch.equal(a, b) for a, b in zip(g, g_ref))


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch):
        yield from self.batches


class _Valid:
    """Five utterances of three lengths, two speech types."""

    def __init__(self):
        rng = np.random.default_rng(9)
        self.items = []
        for i, n in enumerate((900, 1024, 700, 1024, 800)):
            clean = (0.3 * rng.standard_normal(n)).astype(np.float32)
            noisy = (clean + 0.1 * rng.standard_normal(n)).astype(np.float32)
            self.items.append((noisy, clean, f"utt{i}", ("No_reverb", "With_reverb")[i % 2]))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_trainer_on_a_two_card_mesh(weights, tmp_path):
    """Trainer(mesh=) on a (2, 1) CPU mesh: an epoch's losses as without a
    mesh within rtol 1e-5, validation over the mesh's cards with the batch
    rounded up to the 'data' cards, and the same scores."""
    runs = {}
    for name, mesh in (("one", None), ("mesh", cpu_mesh(2))):
        trainer = Trainer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), mesh=mesh,
                          save_dir=str(tmp_path / name), acoustics=ACOUSTICS,
                          train_loader=_Batches(BATCHES[:2]), valid_dataset=_Valid(),
                          validation_metrics=("SI_SDR",), metric_workers=1,
                          valid_batch_size=3, use_tensorboard=False, handle_preemption=False,
                          device="cpu")
        trainer.state.model.load_jax_params(weights["fullsubnet_plus"])
        runs[name] = trainer, trainer._train_epoch(1), trainer._validation_epoch(1)
    (one, one_loss, one_score), (meshed, mesh_loss, mesh_score) = runs["one"], runs["mesh"]
    assert meshed.valid_batch_size == 4 and one.valid_batch_size == 3
    assert meshed.history[0]["steps"] == 2
    np.testing.assert_allclose(mesh_loss, one_loss, rtol=1e-5)
    assert np.isfinite(one_score)
    np.testing.assert_allclose(mesh_score, one_score, rtol=1e-5)
    records = [t.history[0]["validation"] for t in (meshed, one)]
    assert records[0]["batches"] == records[1]["batches"] == 2  # buckets of 3 and 2
    for key in ("losses", "metrics"):
        a, b = (jax.tree_util.tree_leaves(r[key]) for r in records)
        np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("flag,cards,want,taken", [
    ("cuda", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 3),
    ("cuda", 2, ["cuda:0", "cuda:1"], 2),
    ("cuda", 1, ["cuda:0"], 1),
    ("cuda:2", 4, ["cuda:2"], 1),
    ("cpu", 0, ["cpu"], 1),
])
def test_cli_trains_on_every_visible_card_without_rank_flags(flag, cards, want, taken):
    """The training CLI's devices for `--device` in one process: every
    visible card for a bare "cuda", of which `auto_mesh` takes the largest
    count that divides the batch of 18 (JAX's CLI), else the one named."""
    devices = mesh_devices(flag, cards)
    assert devices == [torch.device(d) for d in want]
    mesh = pmesh.auto_mesh(18, devices=devices)
    if taken == 1:
        assert mesh is None
    else:
        assert mesh.shape == {"data": taken, "freq": 1} and mesh.group is None
        assert mesh.data_devices == devices[:taken]
