"""The port's Trainer (train/trainer.py, device="cpu") against the JAX
package's, and its failure handling.

Parity: both trainers start from the same JAX-initialized weights on the
same tiny corpus (dynamic mixing with noise and RIRs, a with_reverb and a
no_reverb validation split in 2 length buckets) and train 2 epochs; both
packages mix through one native library, so their batches are equal bit
for bit (tests/test_torch_data.py). JAX runs at HIGHEST matmul precision.
Tolerances: per-epoch train loss and per-split validation loss within rtol
1e-4 (as tests/test_torch_train.py holds the steps: float32 sum order over
an Adam trajectory), validation metric means within 1e-3 (metrics of
waveforms that differ by float32 rounding), the same best epochs and the
same checkpoint files.

Failure handling mirrors tests/test_failure_handling.py and
tests/test_validation.py for the port: preemption, a failed validation, a
device runtime error, a non-finite step, signal handlers restored, the
heartbeat, `-V` saving the updated best score, the No_reverb gate.
"""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from fullsubnet_plus_torch.data import datasets, loader, native, wav
from fullsubnet_plus_torch.io import checkpoint, convert
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.train.trainer import Trainer
from fullsubnet_plus_tpu.data import datasets as jdatasets
from fullsubnet_plus_tpu.data import loader as jloader
from fullsubnet_plus_tpu.data import native as jnative
from fullsubnet_plus_tpu.eval import metrics as jmetrics
from fullsubnet_plus_tpu.io import checkpoint as jcheckpoint
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.train.trainer import Trainer as JTrainer

SR = 16000
TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64, sr=SR)
METRICS = ("STOI", "SI_SDR", "WB_PESQ_EST")
EPOCHS = 2
LOSS_RTOL, METRIC_ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_corpus")
    rng = np.random.default_rng(21)
    lists = {"clean": [], "noise": [], "rir": []}
    for i in range(8):
        n = int((0.4 + 0.05 * i) * SR)
        t = np.arange(n) / SR
        lists["clean"].append(str(root / f"clean_{i}.wav"))
        wav.write_wav(lists["clean"][-1], 0.3 * np.sin(2 * np.pi * (200 + 30 * i) * t)
                      * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)), SR)
    for i in range(2):
        lists["noise"].append(str(root / f"noise_{i}.wav"))
        wav.write_wav(lists["noise"][-1], 0.1 * rng.standard_normal(SR), SR)
    for i, taps in enumerate((160, 700)):
        rir = rng.standard_normal(taps) * np.exp(-np.arange(taps) / 50.0)
        rir[0] = 1.0
        lists["rir"].append(str(root / f"rir_{i}.wav"))
        wav.write_wav(lists["rir"][-1], rir.astype(np.float32), SR, subtype="FLOAT")
    for kind in lists:
        (root / f"{kind}.txt").write_text("\n".join(lists[kind]) + "\n")
    valid = []
    for split in ("with_reverb", "no_reverb"):
        d = root / split
        for i in range(3):
            n = int((0.3 + 0.15 * i) * SR)
            clean = (0.3 * np.sin(2 * np.pi * (250 + 40 * i) * np.arange(n) / SR)).astype(
                np.float32)
            wav.write_wav(str(d / "clean" / f"clean_fileid_{i}.wav"), clean, SR)
            wav.write_wav(str(d / "noisy" / f"x_snr5_fileid_{i}.wav"),
                          clean + 0.05 * rng.standard_normal(n).astype(np.float32), SR)
        valid.append(str(d))
    return {"lists": {k: str(root / f"{k}.txt") for k in lists}, "valid": valid}


def _datasets(corpus, pkg_datasets, pkg_loader):
    train = pkg_datasets.TrainDataset(
        corpus["lists"]["clean"], corpus["lists"]["noise"], corpus["lists"]["rir"],
        snr_range=(0, 10), reverb_proportion=0.5, sub_sample_length=0.25, seed=0)
    return (pkg_loader.BatchLoader(train, 4, num_workers=2, seed=0),
            pkg_datasets.ValidationDataset(corpus["valid"]))


def _trainer_kwargs(save_dir):
    return dict(save_dir=save_dir, acoustics=ACOUSTICS, epochs=EPOCHS,
                validation_metrics=METRICS, metric_workers=2, valid_batch_size=2,
                valid_num_buckets=2, use_tensorboard=False, lr=1e-3)


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The JAX and the port's trainers, each after EPOCHS epochs, from the
    JAX trainer's initial weights, with what each recorded."""
    with pytest.MonkeyPatch.context() as mp:
        lib = native._load()
        if lib is not None:  # one library for both packages' mixing
            mp.setattr(jnative, "_lib", lib)
        else:
            mp.setitem(native._loaded, "lib", None)
            mp.setattr(jnative, "_lib", None)
            mp.setattr(jnative, "_load", lambda: None)

        jax_dir = str(tmp_path_factory.mktemp("jax_trainer"))
        train_loader, valid = _datasets(corpus, jdatasets, jloader)
        jt = JTrainer(J_MODEL, JConfig(**TINY), train_loader=train_loader,
                      valid_dataset=valid, **_trainer_kwargs(jax_dir))
        initial = jax.tree_util.tree_map(np.asarray, jt.state)
        jax_record = {"train": {}, "valid": {}}
        train_epoch, score_splits = jt._train_epoch, jt._score_splits

        def record_train(epoch):
            jax_record["train"][epoch] = train_epoch(epoch)
            return jax_record["train"][epoch]

        def record_valid(loss_by_type, pairs_by_type, epoch):
            jax_record["valid"][epoch] = (loss_by_type, pairs_by_type)
            return score_splits(loss_by_type, pairs_by_type, epoch)

        jt._train_epoch, jt._score_splits = record_train, record_valid
        with jax.default_matmul_precision("highest"):
            jt.train()

        port_dir = str(tmp_path_factory.mktemp("port_trainer"))
        train_loader, valid = _datasets(corpus, datasets, loader)
        pt = Trainer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), train_loader=train_loader,
                     valid_dataset=valid, device="cpu", **_trainer_kwargs(port_dir))
        adam = jcheckpoint.find_adam_state(initial.opt_state)
        pt.state.load_state_dict(convert.train_state_from_jax(
            initial.params, adam.mu, adam.nu, adam.count, initial.step))
        pt.train()
    return {"jax": jt, "jax_record": jax_record, "port": pt, "jax_dir": jax_dir,
            "port_dir": port_dir}


def test_train_losses_equal_jax(runs):
    port = {r["epoch"]: r["train_loss"] for r in runs["port"].history if "train_loss" in r}
    assert sorted(port) == sorted(runs["jax_record"]["train"]) == [1, 2]
    for epoch, loss in runs["jax_record"]["train"].items():
        np.testing.assert_allclose(port[epoch], loss, rtol=LOSS_RTOL)
    assert port[1] != port[2]
    assert runs["port"].skipped_steps == runs["jax"].skipped_steps == 0
    assert runs["port"]._global_step == runs["jax"]._global_step == 2 * EPOCHS


def test_validation_losses_and_metrics_equal_jax(runs):
    records = {r["epoch"]: r["validation"] for r in runs["port"].history if "validation" in r}
    for epoch, (loss_by_type, pairs_by_type) in runs["jax_record"]["valid"].items():
        got = records[epoch]
        assert set(got["losses"]) == set(loss_by_type) == {"With_reverb", "No_reverb"}
        assert got["batches"] == 4  # 2 buckets of 3 at batch 2
        for speech_type, losses in loss_by_type.items():
            np.testing.assert_allclose(got["losses"][speech_type], np.mean(losses),
                                       rtol=LOSS_RTOL)
            for metric in METRICS:
                want = np.mean([jmetrics.compute_metric(metric, c, e, sr=SR)
                                for c, e in pairs_by_type[speech_type]])
                np.testing.assert_allclose(got["metrics"][speech_type][metric], want,
                                           rtol=0, atol=METRIC_ATOL)


def test_best_epochs_and_checkpoint_files_equal_jax(runs):
    def files(save_dir):
        ckpt = os.path.join(save_dir, "checkpoints")
        return sorted(os.listdir(ckpt)), checkpoint.load_flat(
            os.path.join(ckpt, "best_model.npz"))[1]

    (port_files, port_best), (jax_files, jax_best) = files(runs["port_dir"]), files(
        runs["jax_dir"])
    assert port_files == jax_files == ["best_model.npz", "latest_model.npz",
                                       "model_0001.npz", "model_0002.npz"]
    assert port_best["epoch"] == jax_best["epoch"]
    np.testing.assert_allclose(port_best["best_score"], jax_best["best_score"], rtol=0,
                               atol=METRIC_ATOL)
    for save_dir in (runs["port_dir"], runs["jax_dir"]):
        assert os.path.exists(os.path.join(save_dir, "run_complete.json"))


def test_port_run_resumes_in_jax(runs):
    """The port's latest_model.npz after training continues in the JAX
    trainer, and the JAX one in the port's."""
    template = JTrainer(J_MODEL, JConfig(**TINY), **_trainer_kwargs(runs["port_dir"]))
    template.resume()
    assert template.start_epoch == EPOCHS + 1
    port = runs["port"].state.state_dict()
    np.testing.assert_array_equal(
        np.asarray(template.state.params["sb_model"]["fc_output_layer"]["weight"]),
        port["params"]["sb_model.fc_output_layer.weight"].numpy().T)
    back = Trainer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), device="cpu",
                   **_trainer_kwargs(runs["jax_dir"]))
    back.resume()
    _, meta = jcheckpoint.load_flat(os.path.join(runs["jax_dir"], "checkpoints",
                                                 "latest_model.npz"))
    assert back.start_epoch == EPOCHS + 1 and back.best_score == meta["best_score"]
    assert int(back.state.step) == int(runs["jax"].state.step) == 2 * EPOCHS


# -- failure handling (the port alone) ----------------------------------------

def _port_trainer(tmp_path, train_loader=None, **kw):
    args = dict(save_dir=str(tmp_path), acoustics=ACOUSTICS, epochs=3, use_tensorboard=False,
                device="cpu")
    args.update(kw)
    return Trainer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), train_loader=train_loader,
                   **args)


class _Loader:
    """n_batches of one seeded batch an epoch; optionally a NaN batch at
    `nan_at` or a SIGTERM to this process before batch `preempt_at`."""

    def __init__(self, n_batches=3, preempt_at=None, nan_at=None):
        rng = np.random.default_rng(0)
        self.noisy = (0.1 * rng.standard_normal((4, 2048))).astype(np.float32)
        self.clean = (0.8 * self.noisy).astype(np.float32)
        self.n_batches, self.preempt_at, self.nan_at = n_batches, preempt_at, nan_at
        self.served = 0

    def epoch(self, epoch):
        for i in range(self.n_batches):
            if i == self.preempt_at:
                os.kill(os.getpid(), signal.SIGTERM)
            self.served += 1
            clean = self.clean
            if i == self.nan_at:
                clean = clean.copy()
                clean[0, 100] = np.nan
            yield self.noisy, clean


def test_preemption_checkpoints_and_exits(tmp_path):
    handler = signal.getsignal(signal.SIGTERM)
    feed = _Loader(n_batches=6, preempt_at=2)
    trainer = _port_trainer(tmp_path, feed, heartbeat_interval=1)
    trainer.train()  # returns at the next step boundary
    assert feed.served < feed.n_batches
    _, meta = checkpoint.load_flat(os.path.join(tmp_path, "checkpoints", "latest_model.npz"))
    assert meta["epoch"] == 0  # the interrupted epoch runs again after -R
    assert not os.path.exists(os.path.join(tmp_path, "checkpoints", "model_0000.npz"))
    assert not os.path.exists(os.path.join(tmp_path, "run_complete.json"))
    beat = json.load(open(os.path.join(tmp_path, "heartbeat.json")))
    assert beat["global_step"] >= 1 and beat["skipped_steps"] == 0
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    again = _port_trainer(tmp_path, feed)
    again.resume()
    assert again.start_epoch == 1 and int(again.state.step) == int(trainer.state.step)


def test_handlers_only_installed_during_train(tmp_path):
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    trainer = _port_trainer(tmp_path)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    seen = {}

    def validate(epoch):
        seen["handler"] = signal.getsignal(signal.SIGTERM)
        return 0.5

    trainer._validation_epoch = validate
    trainer.train(only_validation=True)
    assert seen["handler"] == trainer._on_preempt
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    assert trainer._prev_handlers == {}


def test_validation_failure_does_not_kill_training(tmp_path):
    class Failing:
        def __len__(self):
            return 1

        def __getitem__(self, i):
            raise RuntimeError("synthetic validation failure")

    trainer = _port_trainer(tmp_path, _Loader(n_batches=1), valid_dataset=Failing(), epochs=2)
    trainer.train()
    files = os.listdir(os.path.join(tmp_path, "checkpoints"))
    assert "model_0002.npz" in files and "best_model.npz" not in files
    assert os.path.exists(os.path.join(tmp_path, "run_complete.json"))


def test_device_runtime_error_checkpoints_and_exits(tmp_path):
    trainer = _port_trainer(tmp_path, _Loader(n_batches=2), epochs=4)
    real_step, calls = trainer.train_step, {"n": 0}

    def flaky(state, noisy, clean):
        calls["n"] += 1
        if calls["n"] > 2:  # epoch 2's first step
            raise torch.AcceleratorError("CUDA error: an illegal memory access (synthetic)")
        return real_step(state, noisy, clean)

    trainer.train_step = flaky
    trainer.train()  # returns instead of raising
    _, meta = checkpoint.load_flat(os.path.join(tmp_path, "checkpoints", "latest_model.npz"))
    assert meta["epoch"] == 1
    assert not os.path.exists(os.path.join(tmp_path, "run_complete.json"))

    def shape_bug(state, noisy, clean):
        raise RuntimeError("mat1 and mat2 shapes cannot be multiplied (synthetic)")

    trainer.train_step = shape_bug
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        trainer.train()  # a programming error still propagates


def test_nonfinite_step_skipped_and_counted(tmp_path):
    """A NaN batch in each of 2 epochs: rejected on the device, counted when
    its loss is fetched, out of the epoch's mean."""
    trainer = _port_trainer(tmp_path, _Loader(n_batches=3, nan_at=1), epochs=2,
                            heartbeat_interval=1)
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    trainer.train()
    assert trainer.skipped_steps == 2
    for record in trainer.history:
        assert record["skipped"] == 1 and record["steps"] == 3
        assert np.isfinite(record["train_loss"])
    assert int(trainer.state.step) == 6 and int(trainer.state.opt_state.count) == 4
    assert any(not torch.equal(v, before[k]) for k, v in trainer.state.model.state_dict().items())
    # the last heartbeat (step 6) counts epoch 1's skip; epoch 2's loss is
    # fetched at the epoch's end, LOSS_WINDOW steps late at most
    beat = json.load(open(os.path.join(tmp_path, "heartbeat.json")))
    assert beat["skipped_steps"] == 1 and beat["global_step"] == 6
    assert beat["loss"] is not None and np.isfinite(beat["loss"])


def test_only_validation_saves_updated_best(tmp_path):
    trainer = _port_trainer(tmp_path, epochs=1)
    trainer._validation_epoch = lambda epoch: 0.5
    trainer.train(only_validation=True)
    ckpt_dir = os.path.join(tmp_path, "checkpoints")
    _, meta = checkpoint.load_flat(os.path.join(ckpt_dir, "latest_model.npz"))
    assert meta["best_score"] == 0.5
    assert os.path.exists(os.path.join(ckpt_dir, "best_model.npz"))
    assert os.path.exists(os.path.join(tmp_path, "run_complete.json"))


@pytest.mark.parametrize("scores,gate", [
    ({"No_reverb": 0.0, "With_reverb": 0.9}, 0.0),
    ({"With_reverb": 0.4, "No_reverb": 0.7, "Singing": 0.95}, 0.7),
    ({"Emotion": 0.3, "Singing": 0.6}, 0.3),
    ({}, -np.inf),
])
def test_gate_score_equal_jax(scores, gate):
    assert Trainer._gate_score(None, scores) == JTrainer._gate_score(None, scores) == gate


def test_trainer_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        _port_trainer(tmp_path, mesh=object())
    with pytest.raises(ValueError, match="compute_dtype"):
        _port_trainer(tmp_path, compute_dtype="float16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port_trainer(tmp_path, device="cuda")
