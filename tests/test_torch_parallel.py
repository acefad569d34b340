"""The port's multi-device surface in one process, on the CPU: the mesh
(parallel/mesh.py), `drop_band` with a rank's row offset, the fold split of
K1's and K5's wrappers, `Enhancer(mesh=)` against the JAX package's mesh
Enhancer and the port's one-device one, `make_bucketed_eval_step(mesh=)`
against one device, the train step on a one-card mesh (training runs one
rank per card; several cards in one process are refused), and the
pipelined batch CLI against a blocking loop.

A CPU mesh is a grid of "cpu" devices (JAX's: the 8 fake CPU devices of
tests/conftest.py). Sizes are tiny (n_fft 64, hidden <= 32, 33 bins).
Agreement floors are the repo's: waveforms >= 80 dB against JAX at HIGHEST
precision (atol 2e-4 / rtol 1e-3 besides, JAX's own mesh test), and a split
against no split equal where the same rows run the same arithmetic.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.dsp import unfold as junfold
from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.parallel import make_mesh as j_make_mesh
from fullsubnet_plus_torch.cli import enhance as cli_enhance
from fullsubnet_plus_torch.data import wav
from fullsubnet_plus_torch.dsp import unfold
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io.checkpoint import save_flat
from fullsubnet_plus_torch.io.convert import state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.nn.lstm import LSTM2
from fullsubnet_plus_torch.nn.layers import Linear
from fullsubnet_plus_torch.ops import lstm2, lstm2_int8
from fullsubnet_plus_torch.parallel import mesh as pmesh
from fullsubnet_plus_torch.train import loss, step

SMALL = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=32, sb_model_hidden_size=32)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0),
                                                           JConfig(**SMALL)))


def cpu_mesh(data, freq=1):
    return pmesh.make_mesh(data, freq, devices=["cpu"] * (data * freq))


def _sdr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-300))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_and_auto_mesh_shapes():
    mesh = cpu_mesh(4, 2)
    assert mesh.shape == {"data": 4, "freq": 2} and mesh.local_data == 4
    assert mesh.devices.shape == (4, 2) and mesh.group is None
    assert mesh.fold_devices(1, ("data",)) == [torch.device("cpu")]
    assert len(mesh.fold_devices(1, ("data", "freq"))) == 2
    assert pmesh.make_mesh(freq=2, devices=["cpu"] * 6).shape == {"data": 3, "freq": 2}
    # JAX's single-process rule: the largest device count that divides the batch
    assert pmesh.auto_mesh(6, devices=["cpu"] * 4).shape == {"data": 3, "freq": 1}
    assert pmesh.auto_mesh(7, devices=["cpu"] * 4) is None
    assert pmesh.auto_mesh(18, devices=["cpu"]) is None
    assert [s for _, s in pmesh.data_sharding(cpu_mesh(2), 6)] == [slice(0, 3), slice(3, 6)]
    assert pmesh.row_offset(None, 9) == 0


@pytest.mark.parametrize("build,error", [
    (lambda: pmesh.make_mesh(4, 2, devices=["cpu"] * 7), ValueError),
    (lambda: pmesh.make_mesh(freq=3, devices=["cpu"] * 4), ValueError),
    (lambda: pmesh.make_mesh(0, 1, devices=["cpu"]), ValueError),
    (lambda: pmesh.Mesh(["cpu", "cpu"]), ValueError),
    (lambda: pmesh.data_sharding(cpu_mesh(4), 6), ValueError),
    (lambda: cpu_mesh(2, 2).fold_devices(0, ("data", "time")), ValueError),
    (lambda: pmesh.check_mesh(object()), TypeError),
    (lambda: pmesh.check_distributed_args(None, 2, 0), ValueError),
    (lambda: pmesh.check_distributed_args("127.0.0.1:1", 2, 2), ValueError),
    (lambda: pmesh.check_distributed_args(None, None, 1), ValueError),
])
def test_malformed_meshes_and_rank_flags_raise(build, error):
    with pytest.raises(error):
        build()


def test_single_process_run_is_not_distributed():
    pmesh.initialize_distributed(None, None, None)  # a no-op
    assert pmesh.is_primary() and pmesh.process_count() == 1
    assert pmesh.agreed_min(3, cpu_mesh(2)) == 3
    assert pmesh.broadcast_float(0.5, cpu_mesh(2)) == 0.5


def test_multi_rank_run_defaults_to_the_card_and_refuses_without_it(monkeypatch):
    """`initialize_distributed` without `device` asks for the card, as every
    entry point does: on a machine without CUDA a multi-rank call raises
    RuntimeError before any process group, and never falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")

    def no_group(*args, **kwargs):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(pmesh.dist, "init_process_group", no_group)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.initialize_distributed("127.0.0.1:1", 2, 0)
    assert not pmesh.dist.is_initialized() and pmesh.process_count() == 1


# ---------------------------------------------------------------------------
# drop_band with a row offset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,groups,parts", [(6, 2, 2), (18, 2, 2), (9, 3, 3), (6, 3, 2),
                                                (12, 2, 4), (8, 4, 2)])
def test_drop_band_with_offset_is_the_global_rows(batch, groups, parts):
    """Each part's drop_band (its offset, the global batch) is exactly the
    global drop_band's rows of its samples, in order; odd offsets included
    (6 rows in 2 parts: part 1 starts at row 3). The global one is JAX's."""
    freqs = 33
    x = np.arange(batch * 2 * freqs * 3, dtype=np.float32).reshape(batch, 2, freqs, 3)
    ref = np.asarray(junfold.drop_band(jnp.asarray(x), groups))
    whole = unfold.drop_band(torch.tensor(x), groups).numpy()
    np.testing.assert_array_equal(whole, ref)
    source, _ = unfold._drop_band_indices(batch, freqs, groups)
    rows = batch // parts
    for p in range(parts):
        offset = p * rows
        local = unfold.drop_band(torch.tensor(x[offset:offset + rows]), groups,
                                 row_offset=offset, global_batch=batch).numpy()
        mine = (source >= offset) & (source < offset + rows)
        np.testing.assert_array_equal(local, ref[mine])


def test_drop_band_checks_the_global_batch():
    x = torch.zeros(2, 1, 8, 3)
    assert unfold.drop_band(x, 2, row_offset=4, global_batch=6).shape == (2, 1, 4, 3)
    with pytest.raises(ValueError, match="must exceed num_groups"):
        unfold.drop_band(x, 2, global_batch=2)
    with pytest.raises(ValueError, match="not in a batch"):
        unfold.drop_band(x, 2, row_offset=5, global_batch=6)


# ---------------------------------------------------------------------------
# the fold split of the kernels' wrappers (their plain versions here)
# ---------------------------------------------------------------------------

def _lstm(hidden=32, d_in=10, out_dim=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    lstm, fc = LSTM2(d_in, hidden), Linear(hidden, out_dim)
    lstm.reset_parameters(g)
    with torch.no_grad():
        for p in fc.parameters():
            p.uniform_(-0.3, 0.3, generator=g)
    return lstm, fc


@pytest.mark.parametrize("parts", [2, 4])
def test_fold_split_float32_equals_unsplit(parts):
    lstm, fc = _lstm()
    x = torch.randn(8, 10, 7, generator=torch.Generator().manual_seed(1))
    w = lstm.packed(fc)
    ref = lstm2.lstm2_fc(x, w)
    out = lstm2.lstm2_fc_split(x, [w] * parts, ["cpu"] * parts)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("parts", [2, 4])
def test_fold_split_int8_equals_unsplit(parts):
    lstm, fc = _lstm()
    w = lstm.to(torch.bfloat16).prepare_int8(fc)
    x = torch.randn(8, 10, 7, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    ref = lstm2_int8.lstm2_int8_fc(x, w)
    out = lstm2_int8.lstm2_int8_fc_split(x, [lstm2.to_device(w, "cpu")] * parts,
                                         ["cpu"] * parts)
    assert torch.equal(out, ref)


def test_fold_split_that_does_not_divide_warns_and_runs_whole():
    lstm, fc = _lstm()
    x = torch.randn(9, 10, 5, generator=torch.Generator().manual_seed(3))
    w = lstm.packed(fc)
    with pytest.warns(UserWarning, match="does not divide over 2 cards"):
        out = lstm2.lstm2_fc_split(x, [w, w], ["cpu", "cpu"])
    assert torch.equal(out, lstm2.lstm2_fc(x, w))
    with pytest.raises(ValueError, match="weights for"):
        lstm2.lstm2_fc_split(x, [w], ["cpu", "cpu"])


# ---------------------------------------------------------------------------
# Enhancer(mesh=)
# ---------------------------------------------------------------------------

def _noisy(rows=8, samples=4000, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal((rows, samples))).astype(np.float32)


def _enhancer(params, mesh=None, fold=None, dtype=None):
    return Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**SMALL, fold_sharding=fold),
                    state_dict_from_jax(params), mesh=mesh, compute_dtype=dtype, device="cpu",
                    **ACOUSTICS)


def test_mesh_enhancer_matches_jax_mesh_and_one_device(params):
    """tests/test_parallel.py:78-96 in both packages: data 4 x freq 2,
    the fold sharded over 'data'."""
    noisy = _noisy()
    with jax.default_matmul_precision("highest"):
        ref = JEnhancer(J_MODEL, JConfig(**SMALL, fold_sharding=("data",)), params,
                        mesh=j_make_mesh(data=4, freq=2), **ACOUSTICS).enhance_batch(noisy)
    sharded = _enhancer(params, cpu_mesh(4, 2), ("data",))
    assert len(sharded.replicas) == 4
    out = sharded.enhance_batch(noisy)
    assert out.shape == ref.shape == (8, 4000) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)
    assert _sdr(ref, out) >= 80.0, _sdr(ref, out)
    assert _sdr(_enhancer(params).enhance_batch(noisy), out) >= 80.0


@pytest.mark.parametrize("dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("data,freq,fold", [(2, 2, ("data", "freq")), (1, 4, ("freq",)),
                                            (4, 1, None)])
def test_mesh_enhancer_equals_one_device(params, dtype, data, freq, fold):
    """Rows over 'data', each shard's fold over its 'freq' cards, with
    lengths, against one device: equal where the batch is not split (the
    CPU's matrix products round by batch size otherwise), else the repo's
    floors, 80 dB in float32 and 40 in bf16 and int8."""
    noisy, lengths = _noisy(), [4000, 3100, 4000, 2500, 4000, 4000, 3900, 4000]
    ref = _enhancer(params, dtype=dtype).enhance_batch(noisy, lengths=lengths)
    mesh_enhancer = _enhancer(params, cpu_mesh(data, freq), fold, dtype)
    if fold and "freq" in fold:
        assert len(mesh_enhancer.model.sb_model.fold_devices) == freq
        if dtype == "int8":
            assert len(mesh_enhancer.model.sb_model.int8_fold_weights) == freq
    out = mesh_enhancer.enhance_batch(noisy, lengths=lengths, blocking=False).result()
    if data == 1:
        np.testing.assert_array_equal(out, ref)
    else:
        assert _sdr(ref, out) >= (80.0 if dtype is None else 40.0), _sdr(ref, out)


def test_mesh_enhancer_rejects_what_does_not_divide(params):
    with pytest.raises(ValueError, match="does not divide"):
        _enhancer(params, cpu_mesh(4)).enhance_batch(_noisy(6))
    with pytest.raises(TypeError, match="Mesh"):
        _enhancer(params, mesh=[["cpu"]])


def test_mesh_fold_that_does_not_divide_warns(params):
    """B 1 a shard, F 33: a fold of 33 rows over 2 'freq' cards runs whole
    on the shard's card with a warning, as the JAX wrapper does."""
    noisy = _noisy(2)
    with pytest.warns(UserWarning, match="33 rows does not divide"):
        out = _enhancer(params, cpu_mesh(2, 2), ("data", "freq")).enhance_batch(noisy)
    np.testing.assert_array_equal(out, _enhancer(params, cpu_mesh(2)).enhance_batch(noisy))


# ---------------------------------------------------------------------------
# the steps under a single-process mesh
# ---------------------------------------------------------------------------

def test_bucketed_eval_step_mesh_equals_one_device(params):
    model = FULLSUBNET_PLUS.module_cls(FullSubNetPlusConfig(**SMALL)).load_jax_params(params)
    noisy, clean = _noisy(4, 2048, 1), _noisy(4, 2048, 2)
    lengths = np.array([2048, 1500, 1900, 2048])
    one = step.make_bucketed_eval_step(FULLSUBNET_PLUS, FullSubNetPlusConfig(**SMALL),
                                       loss.mse_loss, device="cpu", **ACOUSTICS)
    ref_losses, ref_wave = one(model, noisy, clean, lengths)
    for data, freq, fold in ((2, 1, None), (2, 2, ("data", "freq"))):
        config = FullSubNetPlusConfig(**SMALL, fold_sharding=fold)
        meshed = step.make_bucketed_eval_step(FULLSUBNET_PLUS, config, loss.mse_loss,
                                              mesh=cpu_mesh(data, freq), **ACOUSTICS)
        losses, wave = meshed(model, noisy, clean, lengths)
        np.testing.assert_allclose(losses.numpy(), ref_losses.numpy(), rtol=1e-5)
        assert _sdr(ref_wave, wave) >= 80.0, _sdr(ref_wave, wave)


@pytest.mark.parametrize("data,freq", [(2, 1), (1, 2), (2, 2)])
def test_training_mesh_of_several_cards_in_one_process(data, freq, tmp_path):
    """A training mesh of several cards in one process: the Trainer builds
    on it, rounds its validation batch up to the 'data' cards, splits the
    state's sub-band fold over its 'freq' cards, and takes a finite step
    (tests/test_torch_mesh_train.py holds the numbers to JAX's mesh step)."""
    from fullsubnet_plus_torch.train.trainer import Trainer

    config = FullSubNetPlusConfig(**SMALL, fold_sharding=("data", "freq"))
    trainer = Trainer(FULLSUBNET_PLUS, config, mesh=cpu_mesh(data, freq),
                      save_dir=str(tmp_path), acoustics=ACOUSTICS, valid_batch_size=3,
                      use_tensorboard=False, handle_preemption=False)
    assert trainer.is_primary and trainer.valid_batch_size == -(-3 // data) * data
    clean = _noisy(4, 1024, 3)
    _, metrics = trainer.train_step(trainer.state, clean + 0.5 * _noisy(4, 1024, 4), clean)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["skipped"]) == 0.0
    assert int(trainer.state.step) == 1 and "stop" not in metrics
    folds = trainer.state.model.sb_model.fold_devices
    assert folds == ((torch.device("cpu"),) * freq if freq > 1 else ())


def test_one_card_mesh_step_equals_the_step_without_a_mesh(params):
    """A 1 x 1 mesh without a process group (one rank): the same metrics
    and parameters, bit for bit, as the step without a mesh, over 2 steps."""
    config = FullSubNetPlusConfig(**SMALL)
    optimizer = step.make_optimizer()
    clean = _noisy(4, 1024, 3)
    noisy = clean + _noisy(4, 1024, 4) * 0.5
    runs = {}
    for name, mesh in (("one", None), ("mesh", cpu_mesh(1))):
        model = FULLSUBNET_PLUS.module_cls(config).load_jax_params(params)
        state = step.init_train_state(model, optimizer, device="cpu")
        train_step = step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss,
                                          mesh=mesh, device="cpu", **ACOUSTICS)
        metrics = [{k: float(v) for k, v in train_step(state, noisy, clean)[1].items()}
                   for _ in range(2)]
        runs[name] = metrics, [p.detach().clone() for p in state.model.parameters()]
    assert runs["mesh"][0] == runs["one"][0] and "stop" not in runs["mesh"][0][0]
    for a, b in zip(runs["mesh"][1], runs["one"][1]):
        assert torch.equal(a, b)


class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch):
        yield from self.batches


def test_trainer_on_a_one_card_mesh(tmp_path):
    """Trainer(mesh=) of one CPU device: primary, an epoch's losses as
    without a mesh."""
    from fullsubnet_plus_torch.train.trainer import Trainer

    clean = _noisy(4, 1024, 5)
    batches = [(clean + 0.5 * _noisy(4, 1024, 6 + i), clean) for i in range(2)]
    losses, trainers = {}, {}
    for name, mesh in (("one", None), ("mesh", cpu_mesh(1))):
        trainers[name] = Trainer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**SMALL), mesh=mesh,
                                 save_dir=str(tmp_path / name), acoustics=ACOUSTICS,
                                 valid_batch_size=3, use_tensorboard=False,
                                 handle_preemption=False, device="cpu",
                                 train_loader=_Batches(batches))
        losses[name] = trainers[name]._train_epoch(1)
    assert trainers["mesh"].is_primary and trainers["mesh"].history[0]["steps"] == 2
    assert losses["mesh"] == losses["one"]


def test_fold_split_packs_each_card_once_and_again_after_a_weight_change():
    """K1's operands on the fold's cards are packed once, and packed again
    after an in-place weight update, so the split follows the weights."""
    from fullsubnet_plus_torch.nn.sequence import SequenceModel

    torch.manual_seed(0)
    model = SequenceModel(6, 5, 16, 2, False, "LSTM", output_activate_function=None)
    for p in model.parameters():
        torch.nn.init.uniform_(p, -0.25, 0.25)
    x = torch.randn(8, 6, 12)
    model.shard_fold(["cpu"] * 2)
    with torch.no_grad():
        first = model(x)
        packed = model.fold_packed()
        assert model.fold_packed() is packed and len(packed) == 2
        model.fc_output_layer.bias.add_(0.5)
        assert model.fold_packed() is not packed
        changed = model(x)
        model.shard_fold([])
        unsplit = model(x)
    torch.testing.assert_close(changed, first + 0.5, rtol=1e-5, atol=1e-5)
    assert torch.equal(changed, unsplit)


# ---------------------------------------------------------------------------
# the pipelined batch CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def enhance_inputs(tmp_path, params):
    rng = np.random.default_rng(6)
    lengths = [2600, 4000, 5100, 3300, 4800, 2000, 6000]
    for i, n in enumerate(lengths):
        wav.write_wav(str(tmp_path / "noisy" / f"utt{i}.wav"),
                      (0.2 * rng.standard_normal(n)).astype(np.float32), 16000)
    save_flat(str(tmp_path / "model.npz"), {"params": params}, {"epoch": 0})
    config = {
        "acoustics": {**ACOUSTICS, "sr": 16000},
        "inferencer": {"type": "mag_complex_full_band_crm_mask"},
        "model": {"path": "fullsubnet_plus", "args": SMALL},
    }
    return config, tmp_path, lengths


def test_pipelined_run_enhance_writes_the_blocking_bytes(enhance_inputs, params):
    """4 batches of 2 (more than the window of batches in flight): the same
    bytes as enhancing each batch blocking and writing it before the next."""
    config, root, lengths = enhance_inputs
    stats = cli_enhance.run_enhance(config, str(root / "model.npz"), str(root / "out"),
                                    input_dirs=[str(root / "noisy")], batch_size=2,
                                    device="cpu")
    assert stats["files"] == len(lengths) and -(-len(lengths) // 2) >= cli_enhance.IN_FLIGHT
    assert abs(stats["audio_seconds"] - sum(lengths) / 16000) < 1e-9
    enhancer = _enhancer(params)
    order = np.argsort(lengths, kind="stable")
    for s in range(0, len(order), 2):
        batch = order[s:s + 2]
        n = np.array([lengths[i] for i in batch])
        stacked = np.zeros((len(batch), -(-n.max() // 16000) * 16000), np.float32)
        for j, i in enumerate(batch):
            stacked[j, :n[j]] = wav.read_wav(str(root / "noisy" / f"utt{i}.wav"))
        out = enhancer.enhance_batch(stacked, lengths=n)
        for j, i in enumerate(batch):
            y = out[j, :n[j]]
            wav.write_wav(str(root / "blocking" / f"utt{i}.wav"),
                          y / (np.max(np.abs(y)) + 1e-12) * 0.8, 16000)
    for i in range(len(lengths)):
        with open(root / "out" / f"utt{i}.wav", "rb") as a, \
                open(root / "blocking" / f"utt{i}.wav", "rb") as b:
            assert a.read() == b.read(), i


def test_pipelined_run_enhance_raises_a_failed_write(enhance_inputs, monkeypatch):
    config, root, _ = enhance_inputs
    calls = []
    write = wav.write_wav

    def failing(path, *args, **kwargs):
        calls.append(path)
        if len(calls) == 3:
            raise OSError("disk full")
        return write(path, *args, **kwargs)

    monkeypatch.setattr(wav, "write_wav", failing)
    with pytest.raises(OSError, match="disk full"):
        cli_enhance.run_enhance(config, str(root / "model.npz"), str(root / "out"),
                                input_dirs=[str(root / "noisy")], batch_size=2, device="cpu")
    assert len(calls) < 7  # the writer stopped at the batch that failed


def test_parallel_modules_import_no_jax():
    code = (
        "import sys\n"
        "import fullsubnet_plus_torch.parallel, fullsubnet_plus_torch.parallel.mesh\n"
        "import fullsubnet_plus_torch.cli.train, fullsubnet_plus_torch.cli.enhance\n"
        "import fullsubnet_plus_torch.train.trainer, fullsubnet_plus_torch.train.supervisor\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib',"
        " 'fullsubnet_plus_tpu'))]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_non_primary_supervisor_writes_nothing(tmp_path):
    """A rank > 0's supervisor (`--supervise` with `--host-id 1`) reads rank
    0's marker in the shared save_dir and writes no file of its own; rank
    0's keeps writing supervisor.json."""
    from fullsubnet_plus_torch.train.supervisor import supervise

    save = tmp_path / "run"
    save.mkdir()
    marker = save / "run_complete.json"
    child = [sys.executable, "-c", f"open({str(marker)!r}, 'w').write('{{}}')"]
    assert supervise([], str(save), launcher=child, is_primary=False, poll=0.05,
                     log=lambda *a: None) == 0
    assert sorted(os.listdir(save)) == ["run_complete.json"]
    assert supervise([], str(save), launcher=child, poll=0.05, log=lambda *a: None) == 0
    assert sorted(os.listdir(save)) == ["run_complete.json", "supervisor.json"]
