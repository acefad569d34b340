"""The streaming engine on an NVIDIA GPU (skipped without one).

The engine on the last card (with more than one card, not the thread's
current device) against the same engine on the CPU, with fetches
pipelined: a result read before its copy to the host had finished would
not match. On cuda:3 of four H100 80GB HBM3 (700 W) the fixed engine
measured 112.8-120.4 dB in float32 and 55.4-58.0 dB in int8, and an engine
that recorded its event on the thread's current card gave -10 to 5 dB;
the floors stand 10 dB under the fixed engine's least. Imports nothing of
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_serve_cuda.py
"""

import numpy as np
import pytest
import torch

from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlus, FullSubNetPlusConfig
from fullsubnet_plus_torch.serve import StreamingEngine

# hidden sizes are multiples of 32, as the CUDA LSTM kernels need
CONFIG = FullSubNetPlusConfig(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=32,
                              sb_model_hidden_size=32)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64, sr=1000)
CHUNK, FEED = 4000, 1500


def _serve(device, compute_dtype, utts):
    """Streams fed FEED samples a tick, pipeline depth 2; their outputs."""
    state = FullSubNetPlus(CONFIG).init_weights(torch.Generator().manual_seed(0)).state_dict()
    enhancer = Enhancer(FULLSUBNET_PLUS, CONFIG, state, device=device,
                        compute_dtype=compute_dtype, **ACOUSTICS)
    engine = StreamingEngine(enhancer, slots=2, chunk_samples=CHUNK, pipeline_depth=2)
    sids = [engine.open() for _ in utts]
    outs = {sid: [] for sid in sids}
    for start in range(0, max(map(len, utts)), FEED):
        for sid, y in zip(sids, utts):
            if start < len(y):
                engine.feed(sid, y[start: start + FEED])
                if start + FEED >= len(y):
                    engine.close(sid)
        engine.tick()
        for sid in sids:
            outs[sid].append(engine.pull(sid))
    engine.drain()
    return [np.concatenate(outs[sid] + [engine.pull(sid)]) for sid in sids]


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype,floor_db", [(None, 100.0), ("int8", 45.0)])
def test_engine_on_last_card_matches_cpu(compute_dtype, floor_db):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    device = f"cuda:{torch.cuda.device_count() - 1}"
    rng = np.random.default_rng(0)
    utts = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (9000, 5300, 12500)]
    refs = _serve("cpu", compute_dtype, utts)
    outs = _serve(device, compute_dtype, utts)
    snrs = [round(float(_snr(ref, out)), 1) for ref, out in zip(refs, outs)]
    print(f"{device} {compute_dtype or 'float32'}: SNR against the CPU {snrs} dB")
    for y, out, snr in zip(utts, outs, snrs):
        assert out.shape == y.shape and np.isfinite(out).all()
        assert snr >= floor_db, snrs
