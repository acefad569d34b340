"""The port's host CLIs and utils (fullsubnet_plus_torch/cli/{prepare_data,
synthesize, calculate_metrics, analyse, dns_mos, export_torch,
verify_parity}.py, utils/{misc,profiling,plot}.py) against the JAX
package's, on the same seeded inputs, on the CPU: the same lists, wavs,
metric files, printouts, CSVs and checkpoints. No test reaches the network
(dns_mos's `urlopen` is replaced) or the reference's code.

Tolerances: files and lists equal; resampled and mixed wavs equal to the
sample (both packages share the numpy / scipy recipe); metric means to
rtol 1e-6; an exported state_dict and Adam state equal; the enhanced
waveform of `verify_parity -M` against the JAX pipeline's >= 60 dB (the
int16 write floor is 88 dB).
"""

import csv
import importlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.cli import analyse as j_analyse
from fullsubnet_plus_tpu.cli import calculate_metrics as j_metrics
from fullsubnet_plus_tpu.cli import dns_mos as j_dns_mos
from fullsubnet_plus_tpu.cli import export_torch as j_export
from fullsubnet_plus_tpu.cli import prepare_data as j_prepare
from fullsubnet_plus_tpu.cli import synthesize as j_synthesize
from fullsubnet_plus_tpu.cli import verify_parity as j_verify
from fullsubnet_plus_tpu.utils import misc as j_misc
from fullsubnet_plus_tpu.utils import plot as j_plot
from fullsubnet_plus_tpu.utils import profiling as j_profiling
from fullsubnet_plus_torch.cli import analyse, calculate_metrics, dns_mos, export_torch
from fullsubnet_plus_torch.cli import prepare_data, synthesize, verify_parity
from fullsubnet_plus_torch.data.wav import read_wav, write_wav
from fullsubnet_plus_torch.io.checkpoint import CheckpointManager, save_flat
from fullsubnet_plus_torch.io.convert import jax_from_state_dict
from fullsubnet_plus_torch.models import FULLSUBNET, FULLSUBNET_PLUS
from fullsubnet_plus_torch.train import step
from fullsubnet_plus_torch.utils import misc, plot, profiling

SR = 16000
TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded wavs: 3 tones of 4 s, a 0.5 s silence and a mostly silent
    4 s file (collect-lst's duration and activity gates), 2 noises, and a
    DNS-layout pair directory (clean_fileid_N, noisy_..._fileid_N)."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    t = np.arange(4 * SR) / SR
    for i in range(3):
        write_wav(str(root / "clean" / f"c{i}.wav"),
                  (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32), SR)
    write_wav(str(root / "clean" / "short.wav"), np.zeros(SR // 2, np.float32), SR)
    quiet = np.zeros(4 * SR, np.float32)
    quiet[:SR // 5] = 0.3 * np.sin(2 * np.pi * 300 * t[:SR // 5])
    write_wav(str(root / "clean" / "quiet.wav"), quiet, SR)
    for i in range(2):
        write_wav(str(root / "noise" / f"n{i}.wav"),
                  (0.1 * rng.standard_normal(4 * SR)).astype(np.float32), SR)
    for i in range(4):
        clean = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t[:2 * SR])).astype(np.float32)
        write_wav(str(root / "pairs" / "clean" / f"clean_fileid_{i}.wav"), clean, SR)
        noisy = clean + (0.05 * (i + 1) * rng.standard_normal(2 * SR)).astype(np.float32)
        write_wav(str(root / "pairs" / "noisy" / f"synthetic_noisy_fileid_{i}.wav"), noisy, SR)
    (root / "clean.txt").write_text(
        "".join(str(root / "clean" / f"c{i}.wav") + "\n" for i in range(3)))
    (root / "noise.txt").write_text(
        "".join(str(root / "noise" / f"n{i}.wav") + "\n" for i in range(2)))
    return root


def _both(tmp_path, run):
    """run(package CLI module alias, output directory) for the JAX side and
    the port's side -> (JAX's directory, the port's)."""
    out = {}
    for side in ("jax", "port"):
        out[side] = tmp_path / side
        out[side].mkdir()
        run(side, out[side])
    return out["jax"], out["port"]


def _wavs(directory):
    return {p: read_wav(os.path.join(directory, p))
            for p in sorted(os.path.relpath(os.path.join(r, f), directory)
                            for r, _, files in os.walk(directory) for f in files
                            if f.endswith(".wav"))}


# ---------------------------------------------------------------------------
# prepare_data, synthesize, calculate_metrics, analyse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["gen-lst", "collect-lst"])
def test_prepare_data_lists_match_jax(corpus, tmp_path, cmd):
    """gen-lst lists all 5 wavs; collect-lst keeps the 3 tones (the short
    file fails the duration gate, the mostly silent one the activity gate);
    the port writes JAX's list."""
    flags = ["--min-seconds", "1.0", "--activity-threshold", "0.5", "--workers", "2"]
    cli = {"jax": j_prepare, "port": prepare_data}
    ref, ours = _both(tmp_path, lambda side, out: cli[side].main(
        [cmd, str(corpus / "clean"), str(out / "list.txt"),
         *(flags if cmd == "collect-lst" else [])]))
    listed = (ours / "list.txt").read_text()
    assert listed == (ref / "list.txt").read_text()
    assert len(listed.splitlines()) == (5 if cmd == "gen-lst" else 3)


def test_prepare_data_resample_dir_matches_jax(corpus, tmp_path):
    cli = {"jax": j_prepare, "port": prepare_data}
    ref, ours = _both(tmp_path, lambda side, out: cli[side].main(
        ["resample-dir", str(corpus / "noise"), str(out / "r"), "--sr", "8000",
         "--workers", "2"]))
    want, got = _wavs(ref / "r"), _wavs(ours / "r")
    assert list(got) == list(want) == ["n0.wav", "n1.wav"]
    for name in want:
        assert got[name].shape == (4 * 8000,)
        np.testing.assert_array_equal(got[name], want[name])


def test_synthesize_matches_jax(corpus, tmp_path):
    """The same seed gives JAX's noisy and clean wavs, sample for sample."""
    flags = ["--clean-list", str(corpus / "clean.txt"), "--noise-list", str(corpus / "noise.txt"),
             "--num-files", "3", "--seconds", "2", "--snr-range", "0", "5", "--seed", "7"]
    cli = {"jax": j_synthesize, "port": synthesize}
    ref, ours = _both(tmp_path, lambda side, out: cli[side].main(
        [*flags, "--output-dir", str(out)]))
    want, got = _wavs(ref), _wavs(ours)
    assert list(got) == list(want) and len(got) == 6
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert np.abs(got["noisy/noisy_fileid_0.wav"] - got["clean/clean_fileid_0.wav"]).max() > 1e-4


def test_calculate_metrics_and_analyse_match_jax(corpus, tmp_path, capsys):
    """DNS-1 pairing by fileid (the estimates in reverse name order, one
    extra estimate without a reference), SI_SDR and STOI means and ranked
    files as JAX's; then analyse's comparison of two such runs prints JAX's
    lines, and its histogram is written."""
    est = corpus / "est"
    for i in range(4):
        y = read_wav(str(corpus / "pairs" / "noisy" / f"synthetic_noisy_fileid_{i}.wav"))
        write_wav(str(est / f"{9 - i}_enhanced_fileid_{i}.wav"), y, SR)
    write_wav(str(est / "enhanced_fileid_99.wav"), np.zeros(SR, np.float32), SR)
    flags = ["-R", str(corpus / "pairs" / "clean"), "-E", str(est), "-M", "SI_SDR,STOI",
             "-S", "DNS_1", "--workers", "2"]
    cli = {"jax": j_metrics, "port": calculate_metrics}
    ref, ours = _both(tmp_path, lambda side, out: cli[side].main([*flags, "-D", str(out)]))
    for metric in ("SI_SDR", "STOI"):
        want = (ref / f"{metric}.txt").read_text().splitlines()
        got = (ours / f"{metric}.txt").read_text().splitlines()
        assert len(got) == len(want) == 5  # the mean and 4 pairs
        np.testing.assert_allclose(float(got[0].split()[1]), float(want[0].split()[1]),
                                   rtol=1e-6)
        assert [g.split("\t")[1] for g in got[1:]] == [w.split("\t")[1] for w in want[1:]]
    means = calculate_metrics.main(flags + ["--limit", "2", "--offset", "1"])
    assert set(means) == {"SI_SDR", "STOI"}

    # run b: the same files, SI_SDR up 0.5 for two and down 0.5 for the others
    head, *rows = (ours / "SI_SDR.txt").read_text().splitlines()
    b = tmp_path / "b.txt"
    b.write_text(head + "\n" + "".join(
        f"{float(value) + (0.5 if i % 2 else -0.5):.6f}\t{path}\n"
        for i, (value, path) in enumerate(row.split("\t") for row in rows)))
    capsys.readouterr()
    for package in (j_analyse, analyse):
        package.main(["compare", str(ours / "SI_SDR.txt"), str(b), "--top", "2"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[:len(printed) // 2] == printed[len(printed) // 2:]
    assert "improved: 2  regressed: 2" in printed[0]
    assert plot.compare_two_runs(str(ours / "SI_SDR.txt"), str(b)) == \
        j_plot.compare_two_runs(str(ours / "SI_SDR.txt"), str(b))
    analyse.main(["hist", str(b), "--out", str(tmp_path / "hist.png")])
    assert (tmp_path / "hist.png").stat().st_size > 0


def test_draw_hist_without_matplotlib_raises_clearly(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="draw_hist needs matplotlib"):
        plot.draw_hist([1.0, 2.0])


# ---------------------------------------------------------------------------
# utils: misc, profiling
# ---------------------------------------------------------------------------

def test_misc_helpers_match_jax(tmp_path, capsys):
    """The port's helpers give JAX's results (and take torch tensors)."""
    arr = np.asarray([[1.0, np.nan], [3.0, -2.0]], np.float32)
    assert misc.check_nan(torch.from_numpy(arr), "x") == j_misc.check_nan(arr, "x") is True
    assert misc.check_nan(torch.ones(3)) is False
    misc.print_tensor_info(torch.from_numpy(arr[1]), "t")
    j_misc.print_tensor_info(arr[1], "t")
    printed = capsys.readouterr().out.splitlines()
    assert printed[-1] == printed[-2] and printed[-1].startswith("t\tmax: 3.000000")
    assert misc.basename("/a/b/c.tar.gz") == j_misc.basename("/a/b/c.tar.gz") == ("c.tar", ".gz")
    assert misc.expand_path("~/x") == j_misc.expand_path("~/x")
    assert misc.initialize_module("collections.OrderedDict", {"a": 1}) == {"a": 1}
    assert misc.initialize_module("os.path.join", initialize=False) is os.path.join
    misc.prepare_empty_dir([str(tmp_path / "d")])
    misc.prepare_empty_dir([str(tmp_path / "d")], resume=True)
    with pytest.raises(AssertionError, match="Resuming expects"):
        misc.prepare_empty_dir([str(tmp_path / "missing")], resume=True)
    assert misc.ExecutionTime().duration() == 0


def test_rtf_meter_and_device_trace(tmp_path):
    """RtfMeter counts as JAX's does; device_trace writes a Chrome trace of
    the block (the host's ops here) and is a no-op without a directory."""
    import time

    meters = (profiling.RtfMeter(sr=16000), j_profiling.RtfMeter(sr=16000))
    for meter in meters:
        assert np.isnan(meter.rtf) and np.isnan(meter.throughput)
        with meter.measure(32000):
            time.sleep(0.01)
        assert meter.audio == 2.0 and meter.wall >= 0.01
        assert meter.rtf == pytest.approx(meter.wall / 2.0, rel=1e-12)
        assert meter.throughput == pytest.approx(2.0 / meter.wall, rel=1e-12)
    with profiling.device_trace(None):
        pass
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# dns_mos (urlopen replaced: no network)
# ---------------------------------------------------------------------------

class _FakeService:
    """urlopen's stand-in: the first request for each file fails once (a
    retry), then it answers {"mos": <its index>, "extra": [..]}."""

    def __init__(self):
        self.requests, self.failed = [], set()

    def __call__(self, request, timeout):
        body = json.loads(request.data.decode())
        assert request.full_url == dns_mos.P808_URL == j_dns_mos.P808_URL
        assert request.headers["Authorization"] == "Basic KEY"
        self.requests.append(body["filename"])
        if body["filename"] not in self.failed:
            self.failed.add(body["filename"])
            raise OSError("connection refused")
        mos = float(body["filename"].split("_")[-1].split(".")[0])
        return io.BytesIO(json.dumps({"mos": mos, "extra": [1]}).encode())


def test_dns_mos_matches_jax_with_a_fake_service(corpus, tmp_path, monkeypatch):
    """Both clients, their urlopen and sleep replaced, write the same CSV
    (each file retried once); a second run resumes and asks for nothing;
    without --auth-key both refuse."""
    services, sleeps = {}, []
    for side, module in (("jax", j_dns_mos), ("port", dns_mos)):
        services[side] = _FakeService()
        monkeypatch.setattr(module, "urlopen", services[side])
        monkeypatch.setattr(module.time, "sleep", sleeps.append)
        out = str(tmp_path / f"{side}.csv")
        module.main(["-I", str(corpus / "pairs" / "clean"), "-O", out, "--auth-key", "KEY"])
        module.main(["-I", str(corpus / "pairs" / "clean"), "-O", out, "--auth-key", "KEY"])
        with pytest.raises(SystemExit):
            module.main(["-I", str(corpus / "pairs" / "clean"), "-O", out])
    assert services["port"].requests == services["jax"].requests and \
        len(services["port"].requests) == 8
    assert sleeps == [1] * 8
    rows = list(csv.DictReader(open(tmp_path / "port.csv")))
    assert open(tmp_path / "port.csv").read() == open(tmp_path / "jax.csv").read()
    assert [r["mos"] for r in rows] == ["0.0", "1.0", "2.0", "3.0"]


def test_dns_mos_gives_up_after_its_retries(corpus, tmp_path, monkeypatch):
    def down(request, timeout):
        raise OSError("unreachable")

    monkeypatch.setattr(dns_mos, "urlopen", down)
    monkeypatch.setattr(dns_mos.time, "sleep", lambda s: None)
    with pytest.raises(RuntimeError, match="DNS-MOS scoring failed"):
        dns_mos.score_file(str(corpus / "noise" / "n0.wav"), "KEY", retries=2)


# ---------------------------------------------------------------------------
# export_torch and verify_parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".tar", ".pth"])
def test_export_torch_matches_the_jax_exporter(tmp_path, suffix):
    """A port train state written as the JAX package's latest_model.npz
    (Adam's moments and count set), exported by both CLIs: the port's .tar
    loads strict=True into the port's model, and its state_dict, Adam state
    and metadata equal the JAX exporter's."""
    model = FULLSUBNET_PLUS.module_cls(FULLSUBNET_PLUS.config_cls(**TINY)).init_weights(
        torch.Generator().manual_seed(3))
    optimizer = step.make_optimizer()
    state = step.init_train_state(model, optimizer, device="cpu")
    g = torch.Generator().manual_seed(4)
    state.opt_state.mu.copy_(torch.randn(state.opt_state.mu.shape, generator=g))
    state.opt_state.nu.copy_(torch.rand(state.opt_state.nu.shape, generator=g))
    state.opt_state.count.fill_(3)
    state.step.fill_(3)
    manager = CheckpointManager(str(tmp_path / "run"), lr=5e-4)
    manager.save(state, epoch=2, best_score=0.25)
    outs = {}
    for side, cli in (("jax", j_export), ("port", export_torch)):
        outs[side] = str(tmp_path / f"{side}{suffix}")
        cli.main(["-M", manager.latest_path, "-O", outs[side]])
    ours, theirs = (torch.load(outs[s], map_location="cpu", weights_only=False)
                    for s in ("port", "jax"))
    sd = ours["model"] if suffix == ".tar" else ours
    fresh = FULLSUBNET_PLUS.module_cls(FULLSUBNET_PLUS.config_cls(**TINY))
    fresh.load_state_dict(sd, strict=True)
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    want = theirs["model"] if suffix == ".tar" else theirs
    assert list(sd) == list(want)
    for key in want:
        assert torch.equal(sd[key], torch.as_tensor(want[key])), key
    if suffix == ".pth":
        return
    assert (ours["epoch"], ours["best_score"], ours["scaler"]) == \
        (theirs["epoch"], theirs["best_score"], theirs["scaler"]) == (2, 0.25, theirs["scaler"])
    assert ours["optimizer"]["param_groups"] == theirs["optimizer"]["param_groups"]
    assert ours["optimizer"]["param_groups"][0]["lr"] == 5e-4
    assert ours["optimizer"]["state"].keys() == theirs["optimizer"]["state"].keys()
    for i, entry in theirs["optimizer"]["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ours["optimizer"]["state"][i][name], entry[name]), (i, name)
    # and back: the port's torch reader gives the state it came from
    from fullsubnet_plus_torch.io.checkpoint import load_torch_checkpoint

    back, meta = load_torch_checkpoint(outs["port"])
    assert back["count"] == 3 and meta == {"epoch": 2, "best_score": 0.25}
    for key, value in state.state_dict()["mu"].items():
        assert torch.equal(back["mu"][key], value), key


def test_verify_parity_checkpoint_path_matches_the_jax_pipeline(tmp_path, monkeypatch):
    """-M with a FullSubNet .npz at the shipped config (257 bins): the
    port's enhanced wav against the JAX package's pipeline on the fixture's
    input >= 60 dB; without the reference's code nothing is compared and
    the run passes. Without -M the self-check needs the reference's code
    and exits with JAX's message."""
    monkeypatch.delenv(verify_parity.REFERENCE_ENV, raising=False)
    model = FULLSUBNET.module_cls(FULLSUBNET.config_cls()).init_weights(
        torch.Generator().manual_seed(6))
    params = jax_from_state_dict(model.state_dict())
    ckpt = str(tmp_path / "model.npz")
    save_flat(ckpt, {"params": params}, {"epoch": 1})
    out = str(tmp_path / "enhanced.wav")
    with pytest.raises(SystemExit) as done:
        verify_parity.main(["-M", ckpt, "-O", out, "--model", "fullsubnet", "--device", "cpu"])
    assert done.value.code == 0
    fx = np.load(verify_parity.FIXTURE)
    with jax.default_matmul_precision("highest"):
        ref = j_verify.our_enhance(jax.tree_util.tree_map(jnp.asarray, params), fx["noisy"],
                                   "fullsubnet")
    got = read_wav(out)
    assert got.shape == ref.shape == fx["noisy"].shape
    assert verify_parity.snr_db(np.asarray(ref), got) >= 60.0
    with pytest.raises(SystemExit, match="torch reference code is not available"):
        verify_parity.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="torch reference code is not available"):
        verify_parity.main(["--device", "cpu", "--reference", str(tmp_path / "absent")])


@pytest.mark.parametrize("name", ["analyse", "calculate_metrics", "dns_mos", "export_torch",
                                  "prepare_data", "synthesize", "verify_parity"])
def test_each_host_cli_takes_the_jax_flags(name, capsys):
    """Each CLI's `--help` parses, and every long flag of the JAX CLI's help
    (but its `--device`, whose choices differ) is in the port's."""
    import re

    helps = {}
    for package in ("fullsubnet_plus_tpu", "fullsubnet_plus_torch"):
        module = importlib.import_module(f"{package}.cli.{name}")
        with pytest.raises(SystemExit) as done:
            module.main(["--help"])
        assert done.value.code == 0
        helps[package] = set(re.findall(r"--[a-z][a-z_-]+", capsys.readouterr().out))
    assert helps["fullsubnet_plus_tpu"] - {"--device"} <= helps["fullsubnet_plus_torch"]
