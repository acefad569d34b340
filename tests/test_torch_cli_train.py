"""The port's training CLI end to end on a tiny corpus and model: in
subprocesses (`python -m fullsubnet_plus_torch.cli.train ... --device
cpu`), `-R` continues a run, `--supervise` drives a SIGKILLed run to its
end, and without `--device cpu` on a machine without CUDA it raises before
training; in this process (`cli.train.main`), `--from-torch` continues a
torch Adam run and `-P` warm-starts."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fullsubnet_plus_torch.cli import train as cli
from fullsubnet_plus_torch.data.wav import write_wav
from fullsubnet_plus_torch.io.checkpoint import load_flat
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
MODEL = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
# the reference TOMLs' [model] paths of FullSubNet+ and FullSubNet
MODEL_PATHS = {"fullsubnet_plus": "fullsubnet_plus.model.fullsubnet_plus.FullSubNet_Plus",
               "fullsubnet": "fullsubnet.model.fullsubnet.Model"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_corpus")
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


def _toml(corpus, save_dir, epochs=2, model_path=MODEL_PATHS["fullsubnet_plus"]) -> str:
    path = os.path.join(save_dir + ".toml")
    model = "\n".join(f"{k} = {v}" for k, v in MODEL.items())
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
[train_dataset]
path = "fullsubnet_plus.dataset.dataset_train.Dataset"
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
drop_last = true
[validation_dataset]
path = "fullsubnet_plus.dataset.dataset_validation.Dataset"
[validation_dataset.args]
dataset_dir_list = ["{corpus}/no_reverb"]
sr = 16000
[model]
path = "{model_path}"
[model.args]
{model}
[trainer]
path = "fullsubnet_plus.trainer.trainer.Trainer_Finetune"
[trainer.train]
epochs = {epochs}
clip_grad_norm_value = 10
[trainer.validation]
validation_interval = 1
save_max_metric_score = true
batch_size = 2
[trainer.visualization]
metrics = ["STOI", "SI_SDR"]
num_workers = 1
""")
    return path


def _env():
    return {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def _train(*args, check=True, timeout=300):
    proc = subprocess.run([sys.executable, "-m", "fullsubnet_plus_torch.cli.train", *args],
                          cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=timeout)
    if check:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def _meta(save_dir, name="latest_model.npz"):
    return load_flat(os.path.join(save_dir, "checkpoints", name))


@pytest.mark.parametrize("model", list(MODEL_PATHS))
def test_resume_continues_the_run(corpus, tmp_path, model):
    """One epoch, then -R for the second, then -P warm-starts a fresh run,
    for FullSubNet+ and for FullSubNet (whose LSTMs both train through
    `lstm2_fc_train`)."""
    save_dir = str(tmp_path / "run")
    config = _toml(corpus, save_dir, epochs=2, model_path=MODEL_PATHS[model])
    _train("-C", config, "--device", "cpu", "--epochs", "1")
    flat1, meta1 = _meta(save_dir)
    assert meta1["epoch"] == 1 and not os.path.exists(os.path.join(save_dir,
                                                                   "checkpoints/model_0002.npz"))
    out = _train("-C", config, "--device", "cpu", "-R").stdout
    assert "Resumed from epoch 1" in out and "epoch 1 loss" not in out
    flat2, meta2 = _meta(save_dir)
    assert meta2["epoch"] == 2 and int(flat2["step"]) == int(flat1["step"]) + 2
    assert os.path.exists(os.path.join(save_dir, "run_complete.json"))
    assert os.path.exists(os.path.join(save_dir, "config.toml"))
    # -P, in this process: a fresh run from epoch 2's weights
    warm = str(tmp_path / "warm")
    cli.main(["-C", _toml(corpus, warm, epochs=1, model_path=MODEL_PATHS[model]), "--device",
              "cpu", "-P",
              os.path.join(save_dir, "checkpoints", "model_0002.npz")])
    assert "Preloaded" in open(os.path.join(warm, "train.log")).read()
    assert int(_meta(warm)[0]["step"]) == 2


def test_from_torch_continues_a_torch_adam_run(corpus, tmp_path):
    """A reference-format .tar written by torch.optim.Adam after one step."""
    model = FULLSUBNET_PLUS.module_cls(FullSubNetPlusConfig(**MODEL)).init_weights(
        torch.Generator().manual_seed(1))
    adam = torch.optim.Adam(model.parameters(), lr=1e-3)
    sum(p.square().sum() for p in model.parameters()).backward()
    adam.step()
    tar = str(tmp_path / "latest_model.tar")
    torch.save({"epoch": 1, "best_score": 0.1, "model": model.state_dict(),
                "optimizer": adam.state_dict()}, tar)
    save_dir = str(tmp_path / "run")
    cli.main(["-C", _toml(corpus, save_dir, epochs=2), "--device", "cpu", "--from-torch", tar])
    log = open(os.path.join(save_dir, "train.log")).read()
    assert "Resumed from torch checkpoint" in log and "epoch 1 loss" not in log
    flat, meta = _meta(save_dir)
    assert meta["epoch"] == 2
    assert int(flat["opt_state/1/0/count"]) == int(flat["step"]) == 1 + 2


def test_supervise_recovers_a_killed_child(corpus, tmp_path):
    save_dir = str(tmp_path / "run")
    config = _toml(corpus, save_dir, epochs=3)
    sup = subprocess.Popen([sys.executable, "-m", "fullsubnet_plus_torch.cli.train", "-C",
                            config, "--device", "cpu", "--supervise", "2",
                            "--heartbeat-timeout", "300"],
                           cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        latest = os.path.join(save_dir, "checkpoints", "latest_model.npz")
        deadline = time.time() + 240
        while not os.path.exists(latest) and time.time() < deadline and sup.poll() is None:
            time.sleep(0.05)
        assert os.path.exists(latest), "the first child wrote no checkpoint"
        child = json.load(open(os.path.join(save_dir, "supervisor.json")))["pid"]
        os.kill(child, signal.SIGKILL)  # the exact child pid, no preemption checkpoint
        out, _ = sup.communicate(timeout=300)
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    assert sup.returncode == 0, out[-3000:]
    status = json.load(open(os.path.join(save_dir, "supervisor.json")))
    assert status["phase"] == "complete" and status["attempt"] == 1
    assert "relaunching with -R" in out
    assert _meta(save_dir)[1]["epoch"] == 3
    assert os.path.exists(os.path.join(save_dir, "run_complete.json"))


def test_cuda_by_default_and_refuses_without_it(corpus, tmp_path):
    save_dir = str(tmp_path / "run")
    config = _toml(corpus, save_dir)
    # malformed rank flags raise before anything is launched or written
    for flags in (["--num-hosts", "2", "--host-id", "0"],
                  ["--coordinator", "localhost:1", "--num-hosts", "2", "--host-id", "2"],
                  ["--host-id", "1"]):
        with pytest.raises(ValueError, match="process id|coordinator"):
            cli.main(["-C", config, "--device", "cpu", *flags])
    assert not os.path.exists(save_dir)
    if torch.cuda.is_available():
        return  # the default device is there: nothing to refuse
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-C", config, "--supervise", "2"])  # before any child is launched
    proc = _train("-C", config, check=False, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert not os.path.exists(save_dir)
