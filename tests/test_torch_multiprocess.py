"""Data-parallel training across processes on the CPU: two gloo ranks,
each spawned on a free port (never a fixed one) and importing no JAX, while
this process computes the JAX package's reference.

  * The train step under a 2-rank mesh, 3 rows a rank of a global batch of
    6 with drop_band's 2 groups (so rank 1's rows start at the odd global
    row 3), against the JAX single-device step on the global batch from the
    same weights: loss within rtol 1e-5 and gradient norm within rtol 1e-4
    (gradients, not parameters after Adam, whose elements at its eps may
    flip sign); parameters bit-equal across ranks after 4 steps, a stop flag
    set on one rank read by both. The same with 2 CPU "cards" a rank, 3
    rows a card of a global batch of 12.
  * The Trainer across ranks: validation on rank 0 alone with the score
    broadcast, and a rank-0 failure raising on both; ranks with unequal
    batch counts run the same steps; a SIGTERM flag on one rank stops both
    after the same step.
  * The training CLI as 2 ranks (`--device cpu`) for 2 epochs: the same
    epoch losses on both ranks, files written by rank 0 alone (JAX
    tests/test_multihost.py:370-377), and `-R` continuing both.

Sizes are tiny (n_fft 64, hidden 16, 33 bins).
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.train import loss as jloss
from fullsubnet_plus_tpu.train import step as jstep
from fullsubnet_plus_torch.data.wav import write_wav
from fullsubnet_plus_torch.io.convert import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)
ROWS, RANKS, STEPS, SAMPLES = 3, 2, 4, 1024
SR = 16000

# One rank of the step and Trainer checks; argv: the JSON job and the rank.
WORKER = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.parallel import mesh as pmesh
from fullsubnet_plus_torch.train import loss, step
from fullsubnet_plus_torch.train.trainer import Trainer

job, rank = json.load(open(sys.argv[1])), int(sys.argv[2])
pmesh.TIMEOUT_S = 120  # a rank whose peer died fails the test soon
pmesh.initialize_distributed(job["coordinator"], job["ranks"], rank, device="cpu")
rows = job["rows"]
mesh = pmesh.auto_mesh(rows, devices=["cpu"])
config = FullSubNetPlusConfig(**job["model"])
optimizer = step.make_optimizer()
data = np.load(job["batches"])
mine = slice(rank * rows, (rank + 1) * rows)
out = {"shape": mesh.shape, "offset": pmesh.row_offset(mesh, rows),
       "primary": pmesh.is_primary(), "steps": []}

def flat(model):
    return np.concatenate([p.detach().numpy().ravel() for p in model.parameters()])

model = FULLSUBNET_PLUS.module_cls(config)
model.load_state_dict(torch.load(job["weights"]))
state = step.init_train_state(model, optimizer, device="cpu")
train_step = step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss,
                                  mesh=mesh, **job["acoustics"])
for i in range(job["steps"]):
    state, m = train_step(state, data["noisy"][i][mine], data["clean"][i][mine],
                          stop=rank == 1 and i == 2)
    out["steps"].append({k: float(v) for k, v in m.items()})
np.save(job["params"] % rank, flat(state.model))

# two "cards" a rank: each rank's rows split over its own two, summed there,
# then the one all_reduce over the ranks
wide = pmesh.make_mesh(2 * job["ranks"], 1, devices=["cpu"] * 2)
model = FULLSUBNET_PLUS.module_cls(config)
model.load_state_dict(torch.load(job["weights"]))
wide_state = step.init_train_state(model, optimizer, device="cpu")
wide_step = step.make_train_step(FULLSUBNET_PLUS, config, optimizer, loss.mse_loss,
                                 mesh=wide, **job["acoustics"])
wide_rows = slice(2 * rank * rows, 2 * (rank + 1) * rows)
_, m = wide_step(wide_state, data["wide_noisy"][wide_rows], data["wide_clean"][wide_rows])
out["wide"] = {"shape": wide.shape, "metrics": {k: float(v) for k, v in m.items()}}
np.save(job["wide_params"] % rank, flat(wide_state.model))
out["agreed_min"] = pmesh.agreed_min(5 + rank, mesh)
out["broadcast"] = pmesh.broadcast_float(0.25 + rank, mesh)

trainer = Trainer(FULLSUBNET_PLUS, config, save_dir=job["save_dirs"][rank], mesh=mesh,
                  acoustics=job["acoustics"], use_tensorboard=False, handle_preemption=False)
calls = []

def validate(epoch):
    calls.append(epoch)
    return 0.75

def crash(epoch):
    calls.append(epoch)
    raise RuntimeError("a metric crashed")

trainer._validation_epoch = validate
out["score"] = trainer._validation_score(1)
trainer._validation_epoch = crash
try:
    trainer._validation_score(2)
    out["failure"] = None
except RuntimeError as exc:
    out["failure"] = str(exc)
out["validation_calls"] = calls

class Batches:
    def __init__(self, count):
        self.count = count
    def __len__(self):
        return self.count
    def epoch(self, epoch):
        for i in range(self.count):
            j = i % job["steps"]
            yield data["noisy"][j][mine], data["clean"][j][mine]

trainer.train_loader = Batches(3 if rank == 0 else 2)  # unequal shards of the list
trainer._train_epoch(1)
trainer._preempted = rank == 1  # a SIGTERM on rank 1 alone
trainer.train_loader = Batches(10)
trainer._train_epoch(2)
out["epoch_steps"] = [r["steps"] for r in trainer.history]
out["stop_agreed"] = trainer._stop_agreed
np.save(job["trainer_params"] % rank, flat(trainer.state.model))
out["jax_modules"] = [m for m in sys.modules if m == "jax"
                      or m.startswith(("jax.", "jaxlib", "fullsubnet_plus_tpu"))]
json.dump(out, open(job["out"] % rank, "w"))
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return env


def _wait(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params, cli_run):
    """Both ranks' results, the batches they were fed and the JAX step's
    metrics on the global batch, computed while the ranks run (and while
    the CLI's ranks of `cli_run` run too)."""
    root = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(7)
    clean = (0.1 * rng.standard_normal((STEPS, ROWS * RANKS, SAMPLES))).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
    # two ranks of two cards: a global batch of 4 shards of ROWS rows
    wide_noisy, wide_clean = (np.concatenate([a[0], a[1]]) for a in (noisy, clean))
    np.savez(root / "batches.npz", noisy=noisy, clean=clean, wide_noisy=wide_noisy,
             wide_clean=wide_clean)
    torch.save(state_dict_from_jax(params), root / "weights.pt")
    job = {"coordinator": f"127.0.0.1:{free_port()}", "ranks": RANKS, "rows": ROWS,
           "steps": STEPS, "model": TINY, "acoustics": ACOUSTICS,
           "batches": str(root / "batches.npz"), "weights": str(root / "weights.pt"),
           "params": str(root / "params_%d.npy"), "trainer_params": str(root / "trainer_%d.npy"),
           "wide_params": str(root / "wide_%d.npy"),
           "save_dirs": [str(root / f"run{r}") for r in range(RANKS)],
           "out": str(root / "out_%d.json")}
    (root / "job.json").write_text(json.dumps(job))
    (root / "worker.py").write_text(WORKER)
    procs = [subprocess.Popen([sys.executable, str(root / "worker.py"), str(root / "job.json"),
                               str(r)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    try:
        optimizer = jstep.make_optimizer()
        train_step = jstep.make_train_step(J_MODEL, JConfig(**TINY), optimizer, jloss.mse_loss,
                                           **ACOUSTICS)
        def reference(batch):
            state = jstep.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                           optimizer)
            with jax.default_matmul_precision("highest"):
                return {k: float(v) for k, v in train_step(state, *batch)[1].items()}

        with ThreadPoolExecutor(2) as pool:  # the two batch shapes compile at once
            refs = list(pool.map(reference, ((noisy[0], clean[0]), (wide_noisy, wide_clean))))
    finally:
        logs = _wait(procs, timeout=240)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    outs = [json.loads((root / f"out_{r}.json").read_text()) for r in range(RANKS)]
    return {"outs": outs, "root": root, "jax": refs[0], "jax_wide": refs[1]}


def test_two_rank_step_matches_the_jax_global_step(ranks):
    ref = ranks["jax"]
    for rank, out in enumerate(ranks["outs"]):
        assert out["shape"] == {"data": RANKS, "freq": 1} and out["offset"] == rank * ROWS
        assert out["primary"] == (rank == 0)
        first = out["steps"][0]
        np.testing.assert_allclose(first["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(first["grad_norm"], ref["grad_norm"], rtol=1e-4)
        assert all(m["skipped"] == 0.0 for m in out["steps"])


def test_two_rank_parameters_bit_equal_and_stop_flag_shared(ranks):
    root = ranks["root"]
    a, b = (np.load(root / f"params_{r}.npy") for r in range(RANKS))
    assert a.dtype == np.float32 and np.array_equal(a, b)
    first, second = ranks["outs"]
    assert first["steps"] == second["steps"]  # loss, norm, skipped and stop alike
    assert [m["stop"] for m in first["steps"]] == [0.0, 0.0, 1.0, 0.0]


def test_ranks_of_two_cards_each_match_the_jax_global_step(ranks):
    """2 ranks of 2 CPU "cards" each, ROWS rows a card (the cards' first
    rows at global rows 0, 3, 6, 9): the local sum and the one all_reduce
    compose to JAX's step on the global batch of 4 ROWS, at the tolerances
    above, with the parameters bit-equal across the ranks."""
    ref = ranks["jax_wide"]
    for out in ranks["outs"]:
        m = out["wide"]["metrics"]
        assert out["wide"]["shape"] == {"data": 2 * RANKS, "freq": 1}
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"], rtol=1e-4)
        assert m["skipped"] == 0.0 and m["stop"] == 0.0
    a, b = (np.load(ranks["root"] / f"wide_{r}.npy") for r in range(RANKS))
    assert np.array_equal(a, b)


def test_collectives_and_rank_zero_validation(ranks):
    first, second = ranks["outs"]
    assert first["agreed_min"] == second["agreed_min"] == 5
    assert first["broadcast"] == second["broadcast"] == 0.25
    assert first["score"] == second["score"] == 0.75
    assert first["validation_calls"] == [1, 2] and second["validation_calls"] == []
    assert first["failure"] == second["failure"] == "validation epoch 2 failed on the primary rank"


def test_ranks_agree_step_counts_and_stop_together(ranks):
    """Epoch 1: shards of 3 and 2 batches, both ranks take 2 steps. Epoch 2:
    rank 1's SIGTERM flag rides in its first step's all_reduce, and both
    ranks read it at the same late fetch and stop after the same step."""
    root = ranks["root"]
    first, second = ranks["outs"]
    assert first["epoch_steps"] == second["epoch_steps"]
    assert first["epoch_steps"][0] == 2 and 1 <= first["epoch_steps"][1] < 10
    assert first["stop_agreed"] and second["stop_agreed"]
    a, b = (np.load(root / f"trainer_{r}.npy") for r in range(RANKS))
    assert np.array_equal(a, b)


def test_rank_workers_import_no_jax(ranks):
    assert [out["jax_modules"] for out in ranks["outs"]] == [[], []]


# ---------------------------------------------------------------------------
# the CLI as two ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp_corpus")
    rng = np.random.default_rng(5)
    t = np.arange(SR // 2) / SR
    for kind, count in (("clean", 6), ("noise", 2)):
        paths = []
        for i in range(count):
            paths.append(str(root / kind / f"{kind}_{i}.wav"))
            y = (0.3 * np.sin(2 * np.pi * (220 + 50 * i) * t) if kind == "clean"
                 else 0.1 * rng.standard_normal(len(t)))
            write_wav(paths[-1], y, SR)
        (root / f"{kind}.txt").write_text("\n".join(paths) + "\n")
    d = root / "no_reverb"
    for i in range(2):
        clean = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        write_wav(str(d / "clean" / f"clean_fileid_{i}.wav"), clean, SR)
        write_wav(str(d / "noisy" / f"x_fileid_{i}.wav"),
                  clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32), SR)
    return root


def _toml(corpus, save_dir, epochs) -> str:
    """A tiny run: 3 clean utterances a rank at batch 3, one step an epoch."""
    model = "\n".join(f"{k} = {v}" for k, v in TINY.items())
    path = save_dir + ".toml"
    with open(path, "w") as f:
        f.write(f"""
[meta]
save_dir = "{save_dir}"
seed = 0
[acoustics]
n_fft = 64
win_length = 64
sr = 16000
hop_length = 32
[loss_function]
name = "mse_loss"
[optimizer]
lr = 0.001
[train_dataset.args]
clean_dataset = "{corpus}/clean.txt"
noise_dataset = "{corpus}/noise.txt"
rir_dataset = ""
snr_range = [0, 10]
reverb_proportion = 0.0
sub_sample_length = 0.25
sr = 16000
[train_dataset.dataloader]
batch_size = 3
num_workers = 1
[validation_dataset.args]
dataset_dir_list = ["{corpus}/no_reverb"]
sr = 16000
[model]
path = "fullsubnet_plus"
[model.args]
{model}
[trainer.train]
epochs = {epochs}
clip_grad_norm_value = 10
[trainer.validation]
batch_size = 2
[trainer.visualization]
metrics = ["STOI", "SI_SDR"]
num_workers = 1
""")
    return path


def _launch_ranks(configs, *flags):
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", "fullsubnet_plus_torch.cli.train", "-C", config, "--device",
         "cpu", "--coordinator", f"127.0.0.1:{port}", "--num-hosts", str(len(configs)),
         "--host-id", str(rank), *flags],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank, config in enumerate(configs)]


def _epoch_losses(log: str) -> dict:
    losses = {}
    for line in log.splitlines():
        if "[Train] epoch" in line and " loss " in line:
            words = line.split()
            losses[int(words[words.index("epoch") + 1])] = float(words[words.index("loss") + 1])
    return losses


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def cli_run(corpus, tmp_path_factory):
    """The CLI as 2 ranks for 2 epochs of 3, started here so that it runs
    beside the step's ranks; waited for by the test."""
    root = tmp_path_factory.mktemp("cli_ranks")
    dirs = [str(root / f"run{r}") for r in range(RANKS)]
    configs = [_toml(corpus, d, epochs=3) for d in dirs]
    procs = _launch_ranks(configs, "--epochs", "2")
    yield dirs, configs, procs
    _wait(procs, timeout=5)


def test_cli_two_ranks_train_and_resume(cli_run):
    """Each rank its own save_dir in its config, as in JAX's test: rank 1's
    must stay empty (it holds only the checkpoint copied in for -R, the
    shared file system's view)."""
    dirs, configs, procs = cli_run
    logs = _wait(procs, timeout=240)
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    losses = [_epoch_losses(log) for log in logs]
    assert sorted(losses[0]) == [1, 2] and losses[0] == losses[1]
    assert not os.path.exists(dirs[1])
    written = _files(dirs[0])
    for name in ("train.log", "config.toml", "run_complete.json",
                 os.path.join("checkpoints", "latest_model.npz"),
                 os.path.join("checkpoints", "model_0002.npz")):
        assert name in written, written
    assert _epoch_losses(open(os.path.join(dirs[0], "train.log")).read()) == losses[0]

    os.makedirs(os.path.join(dirs[1], "checkpoints"))
    shutil.copy(os.path.join(dirs[0], "checkpoints", "latest_model.npz"),
                os.path.join(dirs[1], "checkpoints", "latest_model.npz"))
    procs = _launch_ranks(configs, "-R")
    logs = _wait(procs, timeout=240)
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    resumed = [_epoch_losses(log) for log in logs]
    assert sorted(resumed[0]) == [3] and resumed[0] == resumed[1]
    assert "checkpoints/model_0003.npz" in _files(dirs[0])
    assert _files(dirs[1]) == [os.path.join("checkpoints", "latest_model.npz")]


@pytest.mark.slow
def test_cli_two_ranks_kill_and_resume(corpus, tmp_path):
    """JAX's test_cli_train_two_process_kill_and_resume: rank 1 is SIGKILLed
    mid-run, rank 0 fails in its next collective (or is terminated), and
    `-R` on both continues from the last epoch's checkpoint: the epoch
    losses of the interrupted and the resumed run reproduce an unbroken
    run's, and rank 1 wrote nothing of its own."""
    epochs = 12
    gold_dirs = [str(tmp_path / f"gold{r}") for r in range(RANKS)]
    procs = _launch_ranks([_toml(corpus, d, epochs) for d in gold_dirs])
    logs = _wait(procs, timeout=600)
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    gold = _epoch_losses(logs[0])
    assert sorted(gold) == list(range(1, epochs + 1)) and gold == _epoch_losses(logs[1])

    dirs = [str(tmp_path / f"run{r}") for r in range(RANKS)]
    configs = [_toml(corpus, d, epochs) for d in dirs]
    log_path = os.path.join(dirs[0], "train.log")
    procs = _launch_ranks(configs)
    try:
        deadline = time.time() + 300
        while time.time() < deadline and procs[0].poll() is None and len(_epoch_losses(
                open(log_path).read() if os.path.exists(log_path) else "")) < 3:
            time.sleep(0.1)
        assert procs[0].poll() is None, "the run ended before the kill"
        procs[1].send_signal(signal.SIGKILL)
        try:
            procs[0].wait(timeout=60)
        except subprocess.TimeoutExpired:
            procs[0].terminate()
        _wait(procs, timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    interrupted = _epoch_losses(open(log_path).read())
    assert 0 < len(interrupted) < epochs, interrupted
    assert not os.path.exists(os.path.join(dirs[0], "run_complete.json"))
    assert not os.path.exists(dirs[1])
    os.makedirs(os.path.join(dirs[1], "checkpoints"))
    shutil.copy(os.path.join(dirs[0], "checkpoints", "latest_model.npz"),
                os.path.join(dirs[1], "checkpoints", "latest_model.npz"))
    procs = _launch_ranks(configs, "-R")
    logs = _wait(procs, timeout=600)
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:]
    assert os.path.exists(os.path.join(dirs[0], "run_complete.json"))
    resumed = _epoch_losses(open(log_path).read())  # the union: train.log is appended to
    assert sorted(resumed) == list(range(1, epochs + 1))
    for epoch, value in gold.items():
        np.testing.assert_allclose(resumed[epoch], value, rtol=1e-6, err_msg=f"epoch {epoch}")
    assert _files(dirs[1]) == [os.path.join("checkpoints", "latest_model.npz")]
