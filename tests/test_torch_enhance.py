"""The port's enhancement path (fullsubnet_plus_torch.enhance, its CLI)
against the JAX package's, on the CPU at a tiny config (n_fft 64, hidden 16):
the same JAX-initialized weights and numpy waveforms, JAX at HIGHEST matmul
precision, the port in float32 with device="cpu". Waveform agreement is held
to >= 60 dB; masked-against-exact-length to 80 dB (float32 round-off: the
JAX package's own test measures about 124 dB)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_torch.cli.enhance import run_enhance
from fullsubnet_plus_torch.data.wav import read_wav, write_wav
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io.checkpoint import save_flat
from fullsubnet_plus_torch.io.convert import state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, J_MODEL.init(jax.random.PRNGKey(0), JConfig(**TINY)))


@pytest.fixture(scope="module")
def enhancer(params):
    return Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                    device="cpu", **ACOUSTICS)


def _sdr(ref, out):
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


@pytest.mark.parametrize("lengths", [None, [2500, 4000]])
def test_enhancer_matches_jax(params, enhancer, lengths):
    rng = np.random.default_rng(0)
    noisy = (0.1 * rng.standard_normal((2, 4000))).astype(np.float32)
    if lengths is not None:
        noisy[0, lengths[0]:] = 0.0
    with jax.default_matmul_precision("highest"):
        ref = JEnhancer(J_MODEL, JConfig(**TINY), params, **ACOUSTICS).enhance_batch(
            noisy, lengths=lengths)
    out = enhancer.enhance_batch(noisy, lengths=lengths)
    assert out.shape == noisy.shape and out.dtype == np.float32
    assert _sdr(ref, out) >= 60.0, _sdr(ref, out)


def test_length_masked_batch_matches_exact(enhancer):
    """A padded batch with true lengths matches each exact-length run; an
    utterance ending within n_fft//2 of the bucket edge too."""
    rng = np.random.default_rng(3)
    for n_short in (2500, 3984):
        n_long = 4000
        short = (0.1 * rng.standard_normal(n_short)).astype(np.float32)
        longer = (0.1 * rng.standard_normal(n_long)).astype(np.float32)
        padded = np.zeros((2, n_long), np.float32)
        padded[0, :n_short], padded[1] = short, longer
        masked = enhancer.enhance_batch(padded, lengths=[n_short, n_long])
        assert _sdr(enhancer.enhance_batch(short[None])[0], masked[0, :n_short]) > 80.0
        assert _sdr(enhancer.enhance_batch(longer[None])[0], masked[1]) > 80.0
    unmasked = enhancer.enhance_batch(padded)  # without lengths, padding leaks in
    assert _sdr(enhancer.enhance_batch(short[None])[0], unmasked[0, :n_short]) < 60.0


def test_enhance_batch_rejects_bad_lengths(enhancer):
    noisy = np.zeros((2, 1000), np.float32)
    for lengths in ([0, 1000], [500, 1001], [500]):
        with pytest.raises(ValueError, match="lengths"):
            enhancer.enhance_batch(noisy, lengths=lengths)


def test_enhance_rescales_to_peak(enhancer):
    y = enhancer.enhance((0.1 * np.random.default_rng(1).standard_normal(3000)).astype(np.float32))
    assert y.shape == (3000,) and np.isfinite(y).all()
    assert abs(np.max(np.abs(y)) - 0.8) < 1e-5


def test_bfloat16_close_to_float32(params, enhancer):
    noisy = (0.1 * np.random.default_rng(2).standard_normal((2, 4000))).astype(np.float32)
    bf16 = Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                    compute_dtype="bfloat16", device="cpu", **ACOUSTICS)
    assert next(bf16.model.parameters()).dtype == torch.bfloat16
    out = bf16.enhance_batch(noisy)
    assert np.isfinite(out).all()
    assert _sdr(enhancer.enhance_batch(noisy), out) > 20.0  # the JAX package's own bar


def test_run_enhance_end_to_end_on_cpu(tmp_path, params):
    """Wavs and a JAX-format .npz in, rescaled wavs of the same length out."""
    rng = np.random.default_rng(4)
    lengths = [2600, 4000, 5100]
    for i, n in enumerate(lengths):
        write_wav(str(tmp_path / "noisy" / f"utt{i}.wav"),
                  (0.2 * rng.standard_normal(n)).astype(np.float32), 16000)
    save_flat(str(tmp_path / "model.npz"), {"params": params}, {"epoch": 0})
    config = {
        "acoustics": {"n_fft": 64, "hop_length": 32, "win_length": 64, "sr": 16000},
        "inferencer": {"type": "mag_complex_full_band_crm_mask"},
        "model": {"path": "fullsubnet_plus", "args": TINY},
    }
    stats = run_enhance(config, str(tmp_path / "model.npz"), str(tmp_path / "out"),
                        input_dirs=[str(tmp_path / "noisy")], batch_size=2, device="cpu")
    assert stats["files"] == 3 and stats["device"] == "cpu"
    assert abs(stats["audio_seconds"] - sum(lengths) / 16000) < 1e-9
    for i, n in enumerate(lengths):
        y = read_wav(str(tmp_path / "out" / f"utt{i}.wav"))
        assert y.shape == (n,) and np.isfinite(y).all()
        assert abs(np.max(np.abs(y)) - 0.8) < 1e-3  # int16 quantization


def test_int8_constructs_and_sets_quantized_lstm(params):
    """compute_dtype="int8" (the serving default) builds a bf16 model with
    the quantized sub-band LSTM and its int8 weights prepared once."""
    e = Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                 compute_dtype="int8", device="cpu", **ACOUSTICS)
    assert e.model.config.quantized_lstm and e.dtype == torch.bfloat16
    assert e.model.sb_model.int8_weights.u1q.dtype == torch.int8


@pytest.mark.parametrize("kwargs,error,match", [
    ({"mesh": object()}, TypeError, "must be a fullsubnet_plus_torch.parallel.Mesh"),
    ({"inference_type": "no_such_mode"}, NotImplementedError, "Unknown inference type"),
])
def test_unported_enhancer_options_raise(params, kwargs, error, match):
    """A malformed mesh and an unknown mode raise (`mesh=` itself works:
    tests/test_torch_parallel.py)."""
    with pytest.raises(error, match=match):
        Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                 device="cpu", **{**ACOUSTICS, **kwargs})


def test_cuda_without_gpu_raises(params):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                 **ACOUSTICS)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import fullsubnet_plus_torch, fullsubnet_plus_torch.cli.enhance\n"
        "import fullsubnet_plus_torch.enhance, fullsubnet_plus_torch.io.convert\n"
        "import fullsubnet_plus_torch.data.datasets, fullsubnet_plus_torch.utils.config\n"
        "import fullsubnet_plus_torch.serve, fullsubnet_plus_torch.cli.serve\n"
        "import fullsubnet_plus_torch.ops.lstm2_int8, fullsubnet_plus_torch.models.fullsubnet\n"
        "import fullsubnet_plus_torch.utils.logger, fullsubnet_plus_torch.utils.tb_events\n"
        "import fullsubnet_plus_torch.dsp.audio, fullsubnet_plus_torch.data.native\n"
        "import fullsubnet_plus_torch.data.mixing, fullsubnet_plus_torch.data.loader\n"
        "import fullsubnet_plus_torch.eval.stoi, fullsubnet_plus_torch.eval.pesq_estimator\n"
        "import fullsubnet_plus_torch.eval.metrics, fullsubnet_plus_torch.io.checkpoint\n"
        "import fullsubnet_plus_torch.train.trainer, fullsubnet_plus_torch.train.supervisor\n"
        "import fullsubnet_plus_torch.cli.train, fullsubnet_plus_torch.nn.init\n"
        "import fullsubnet_plus_torch.nn.feature_norm, fullsubnet_plus_torch.dsp.multichannel\n"
        "from fullsubnet_plus_torch.utils.config import dump_config, merge_config\n"
        "from fullsubnet_plus_torch.data.datasets import TrainDataset, ValidationDataset\n"
        "from fullsubnet_plus_torch.io.checkpoint import CheckpointManager, load_torch_checkpoint\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib',"
        " 'fullsubnet_plus_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
