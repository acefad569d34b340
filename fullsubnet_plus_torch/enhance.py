"""Enhancement engine: the shipped inference mode on FullSubNet+.

Counterpart of fullsubnet_plus_tpu/enhance.py:34-88, 128-282
(`Enhancer.mag_complex_full_band_crm_mask`, reference inferencer.py:140-165):
STFT -> model -> cIRM decompression -> complex multiply -> iSTFT, on batches
of utterances right-padded to a shared length. With `lengths`, each row of a
padded batch matches its exact-length run: the padded tail is rewritten with
the reflection torch.stft's center padding would see, every statistic over
time in the model is masked to the valid frames, and the iSTFT normalizes
with each utterance's own window envelope.

compute_dtype None or "float32" is the parity path. "bfloat16" casts the
model's weights and inputs; the STFT, mask and iSTFT stay float32, as in
the JAX package. Float32 matmuls must run in full float32 on the card, so
the float32 path refuses to run with TF32 matmuls enabled.
"""

from __future__ import annotations

import numpy as np
import torch

from fullsubnet_plus_torch.device import not_ported, resolve_device
from fullsubnet_plus_torch.dsp.mask import complex_mul, decompress_cirm
from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.dsp.stft import istft, stft_split

# the JAX package's other inference modes (enhance.py:284-508 there)
OTHER_MODES = ("full_band_crm_mask", "sub_band_crm_mask", "complex_full_band_crm_mask",
               "mag", "scaled_mask", "overlapped_chunk", "time_domain")


def _crm_to_wave(crm, noisy_real, noisy_imag, length, n_fft, hop, win, valid_frames=None):
    """decompress cIRM -> complex multiply -> iSTFT. With `valid_frames`,
    frames past each utterance's own count are zeroed before the OLA."""
    crm = decompress_cirm(crm)
    real, imag = complex_mul(noisy_real, noisy_imag, crm[..., 0], crm[..., 1])
    if valid_frames is not None:
        mask = time_mask(real.shape[-1], valid_frames, real.dtype)[:, None, :]
        real, imag = real * mask, imag * mask
    return istft(real, imag, n_fft, hop, win, length=length, valid_frames=valid_frames)


def _reflect_fix_tail(noisy: torch.Tensor, lengths: torch.Tensor, n_fft: int, hop: int):
    """Extend [B, L] by one hop-aligned region and write, after each row's
    true end, the reflection torch.stft's center padding would give its
    exact-length run (y[L-2-j] at L+j)."""
    pad = n_fft // 2
    pad_ext = -(-pad // hop) * hop
    ext = torch.nn.functional.pad(noisy, (0, pad_ext))
    offsets = torch.arange(pad, device=noisy.device)
    starts = torch.clamp(lengths - pad - 1, min=0)
    tails = noisy.gather(1, starts[:, None] + offsets)  # y[L-pad-1+j]
    return ext.scatter(1, lengths[:, None] + offsets, tails.flip(1))


class Enhancer:
    """Batched enhancement with a FullSubNet+ state_dict (reference layout).

    Runs on `device` ("cuda" by default; "cpu" on request). Raises for what
    this slice has not ported."""

    def __init__(self, model_def, model_config, state_dict, *,
                 inference_type="mag_complex_full_band_crm_mask", n_fft=512,
                 hop_length=256, win_length=512, sr=16000, mesh=None, compute_dtype=None,
                 device="cuda"):
        if inference_type in OTHER_MODES:
            raise not_ported(f"inference type {inference_type!r}", "Queue 1 item 7")
        if inference_type != "mag_complex_full_band_crm_mask":
            raise NotImplementedError(f"Unknown inference type {inference_type}")
        if mesh is not None:
            raise not_ported("mesh= (multi-device enhancement)", "Queue 1 item 10")
        if compute_dtype == "int8":
            raise not_ported("compute_dtype='int8'", "Queue 2 item 2")
        if compute_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        self.model_def = model_def
        self.model_config = model_config
        self.inference_type = inference_type
        self.n_fft, self.hop, self.win = n_fft, hop_length, win_length
        self.sr = sr
        model = model_def.module_cls(model_config)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()

    def enhance_batch(self, noisy: np.ndarray, lengths=None) -> np.ndarray:
        """[B, L] float32 -> [B, L] float32 (no rescale). `lengths`: each
        utterance's true sample count in a zero-padded batch."""
        x = torch.as_tensor(np.asarray(noisy, np.float32), device=self.device)
        lens = None
        if lengths is not None:
            lengths = np.asarray(lengths, np.int64)
            if lengths.shape != x.shape[:1] or lengths.min() < 1 or lengths.max() > x.shape[1]:
                raise ValueError(f"lengths must be [B] counts in 1..{x.shape[1]}")
            lens = torch.as_tensor(lengths, device=self.device)
        return self.mag_complex_full_band_crm_mask(x, lens).cpu().numpy()

    def enhance(self, noisy: np.ndarray) -> np.ndarray:
        """[L] -> [L], rescaled to 0.8 of peak (base_inferencer.py:148-152)."""
        enhanced = self.enhance_batch(noisy[None])[0]
        return (enhanced / (np.max(np.abs(enhanced)) + 1e-12) * 0.8).astype(np.float32)

    @torch.inference_mode()
    def mag_complex_full_band_crm_mask(self, noisy: torch.Tensor,
                                       lengths: torch.Tensor | None = None) -> torch.Tensor:
        """[B, L] tensor on the engine's device -> [B, L] float32 waveform."""
        if (self.dtype == torch.float32 and self.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError("the float32 path needs full-precision matmuls: "
                               "torch.backends.cuda.matmul.allow_tf32 is True")
        length = noisy.shape[-1]
        valid_frames = None
        if lengths is not None:
            noisy = _reflect_fix_tail(noisy, lengths, self.n_fft, self.hop)
            valid_frames = 1 + lengths // self.hop
        mag, real, imag = stft_split(noisy, self.n_fft, self.hop, self.win)
        views = (v[:, None].to(self.dtype) for v in (mag, real, imag))
        crm = self.model(*views, valid_frames=valid_frames).float()
        crm = crm.permute(0, 2, 3, 1)  # [B, F, T, 2]
        return _crm_to_wave(crm, real, imag, length, self.n_fft, self.hop, self.win,
                            valid_frames=valid_frames)
