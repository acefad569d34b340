"""Enhancement engine: every inference mode of the reference Inferencer.

Counterpart of fullsubnet_plus_tpu/enhance.py:34-508 (reference
inferencer.py:52-256, base_inferencer.py:134-160). The shipped mode,
`mag_complex_full_band_crm_mask` on FullSubNet+ (three views), and
`full_band_crm_mask` on the FullSubNet baseline (the magnitude alone) run
STFT -> model -> cIRM decompression -> complex multiply -> iSTFT on batches
of utterances right-padded to a shared length. With `lengths`, each row of a
padded batch matches its exact-length run: the padded tail is rewritten with
the reflection torch.stft's center padding would see, every statistic over
time in the model is masked to the valid frames, and the iSTFT normalizes
with each utterance's own window envelope. `sub_band_crm_mask` is
length-aware too. The other modes serve model families no shipped config
has (a two-channel real/imag input, a magnitude or scaling mask, a
waveform model) and take any module of the right signature;
`overlapped_chunk` enhances one long utterance in 50 %-overlapped chunks
through the length-aware base mode at one fixed batch shape.

compute_dtype None or "float32" is the parity path. "bfloat16" casts the
model's weights and inputs; the STFT, mask and iSTFT stay float32, as in
the JAX package. "int8" is the serving default: bfloat16, with the LSTMs'
recurrent products in int8 (ops/lstm2_int8.py), their weights quantized
once here at construction (enhance.py:91-159 of the JAX package). Float32
matmuls must run in full float32 on the card, so the float32 path refuses
to run with TF32 matmuls enabled.

`mesh=` (a parallel.Mesh of this process's cards) splits each batch's rows
over the 'data' cards, one copy of the model on each, and with the model
config's `fold_sharding` naming 'freq' splits each shard's sub-band fold
over its 'freq' cards (JAX enhance.py:138, :225-243). `enhance_batch`
dispatches every shard before it waits on any: the batch goes up from
pinned host memory and comes back into it without blocking, with an event
on each shard's card; `blocking=False` returns that pending result, so a
caller can prepare the next batch while the cards run (cli/enhance.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fullsubnet_plus_torch.device import resolve_device
from fullsubnet_plus_torch.dsp.mask import complex_mul, decompress_cirm
from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.dsp.stft import istft, mag_phase, stft_split
from fullsubnet_plus_torch.dsp.unfold import freq_unfold
from fullsubnet_plus_torch.parallel.mesh import check_mesh, data_sharding, replicated


def _crm_to_wave(crm, noisy_real, noisy_imag, length, n_fft, hop, win, valid_frames=None):
    """decompress cIRM -> complex multiply -> iSTFT. With `valid_frames`,
    frames past each utterance's own count are zeroed before the OLA."""
    crm = decompress_cirm(crm)
    real, imag = complex_mul(noisy_real, noisy_imag, crm[..., 0], crm[..., 1])
    if valid_frames is not None:
        mask = time_mask(real.shape[-1], valid_frames, real.dtype)[:, None, :]
        real, imag = real * mask, imag * mask
    return istft(real, imag, n_fft, hop, win, length=length, valid_frames=valid_frames)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card through pinned memory without
    blocking the host (a pageable copy would wait for the card's queue)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class PendingBatch:
    """An enhanced batch on its way to the host: each shard's output copied
    into pinned host memory behind its card's queue, with an event recorded
    on that card's stream. `result()` waits for them and returns the [B, L]
    float32 array (the shards' rows in order)."""

    def __init__(self):
        self._parts = []
        self._result = None

    def add(self, y: torch.Tensor) -> None:
        if y.device.type != "cuda":
            self._parts.append((y.float(), None))
            return
        host = torch.empty(y.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(y.float(), non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(y.device))
        self._parts.append((host, event))

    def result(self) -> np.ndarray:
        if self._result is None:
            for _, event in self._parts:
                if event is not None:
                    event.synchronize()
            self._result = np.concatenate([host.numpy() for host, _ in self._parts])
            self._parts = []
        return self._result


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
    """Batched enhancement with a model's state_dict (reference layout).

    `inference_type` picks the mode (`MODES`), as the reference's config
    does (base_inferencer.py:134-136); `n_neighbor` is the sub-band mode's
    unfold width and `inference_args` the config's [inferencer.args] table
    (`pad_mode` of `sub_band_crm_mask`, `chunk_length` in seconds of
    `overlapped_chunk`). Runs on `device` ("cuda" by default; "cpu" on
    request), or on the cards of `mesh`."""

    MODES = ("mag_complex_full_band_crm_mask", "full_band_crm_mask", "sub_band_crm_mask",
             "complex_full_band_crm_mask", "mag", "scaled_mask", "overlapped_chunk",
             "time_domain")
    # modes that take per-utterance true lengths for bucket-padded batches
    # (the serving engine's zero-padded tail chunks need them)
    LENGTH_AWARE_MODES = ("mag_complex_full_band_crm_mask", "full_band_crm_mask",
                          "sub_band_crm_mask")

    def __init__(self, model_def, model_config, state_dict, *,
                 inference_type="mag_complex_full_band_crm_mask", n_fft=512,
                 hop_length=256, win_length=512, sr=16000, n_neighbor=15, mesh=None,
                 compute_dtype=None, inference_args=None, device="cuda"):
        if inference_type not in self.MODES:
            raise NotImplementedError(f"Unknown inference type {inference_type}")
        if compute_dtype not in (None, "float32", "bfloat16", "int8"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        if mesh is not None:
            check_mesh(mesh)
            if mesh.process_count > 1:
                raise ValueError("the Enhancer takes a mesh of this process's own cards, "
                                 f"not one across {mesh.process_count} ranks")
            for dev in mesh.devices.ravel():
                resolve_device(dev)
            device = mesh.data_devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dtype = torch.float32 if compute_dtype in (None, "float32") else torch.bfloat16
        if compute_dtype == "int8":
            model_config = dataclasses.replace(model_config, quantized_lstm=True)
        self.model_def = model_def
        self.model_config = model_config
        self.inference_type = inference_type
        self.n_fft, self.hop, self.win = n_fft, hop_length, win_length
        self.sr = sr
        self.n_neighbor = n_neighbor
        self.inference_args = dict(inference_args or {})
        model = model_def.module_cls(model_config)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        # one copy of the model per 'data' card; `_shard` picks the one the
        # mode functions run (0 without a mesh)
        self.replicas = [self.model] if mesh is None else replicated(mesh, self.model)
        self._shard = 0
        fold = getattr(model_config, "fold_sharding", None)
        for i, replica in enumerate(self.replicas):
            if fold and mesh is not None:
                replica.shard_fold(mesh.fold_devices(i, fold))
            if compute_dtype == "int8":
                replica.prepare_int8()

    def enhance_batch(self, noisy: np.ndarray, lengths=None, *, blocking: bool = True):
        """[B, L] float32 -> [B, L] float32 (no rescale). `lengths`: each
        utterance's true sample count in a zero-padded batch; a mode that
        cannot honor them raises rather than return padding-contaminated
        output. Under a mesh the rows split over its 'data' cards (they must
        divide). `blocking=False` returns a `PendingBatch` at once: every
        shard is queued, and its `result()` waits for the cards."""
        noisy = np.asarray(noisy, np.float32)
        mode = getattr(self, self.inference_type)
        if lengths is not None:
            if self.inference_type not in self.LENGTH_AWARE_MODES:
                raise ValueError(f"inference type {self.inference_type!r} cannot honor "
                                 f"`lengths` (only {self.LENGTH_AWARE_MODES})")
            lengths = np.asarray(lengths, np.int64)
            if (lengths.shape != noisy.shape[:1] or lengths.min() < 1
                    or lengths.max() > noisy.shape[1]):
                raise ValueError(f"lengths must be [B] counts in 1..{noisy.shape[1]}")
        shards = ([(self.device, slice(None))] if self.mesh is None
                  else data_sharding(self.mesh, noisy.shape[0]))
        pending = PendingBatch()
        try:
            for i, (device, rows) in enumerate(shards):
                self._shard = i
                args = [_upload(noisy[rows], device)]
                if lengths is not None:
                    args.append(_upload(lengths[rows], device))
                pending.add(mode(*args))
        finally:
            self._shard = 0
        return pending.result() if blocking else pending

    def enhance(self, noisy: np.ndarray) -> np.ndarray:
        """[L] -> [L], rescaled to 0.8 of peak (base_inferencer.py:148-152)."""
        enhanced = self.enhance_batch(noisy[None])[0]
        return (enhanced / (np.max(np.abs(enhanced)) + 1e-12) * 0.8).astype(np.float32)

    # -- helpers --------------------------------------------------------------

    def _check_precision(self) -> None:
        if (self.dtype == torch.float32 and self.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError("the float32 path needs full-precision matmuls: "
                               "torch.backends.cuda.matmul.allow_tf32 is True")

    def _model(self, *inputs, **kwargs) -> torch.Tensor:
        """The model on float32 inputs cast to the compute dtype; float32 out."""
        self._check_precision()
        model = self.replicas[self._shard]
        return model(*(x.to(self.dtype) for x in inputs), **kwargs).float()

    def _spectrum(self, noisy: torch.Tensor, lengths: torch.Tensor | None):
        """(mag, real, imag, valid_frames) of a batch; with `lengths`, of the
        tail-fixed extension, with each row's valid frame count."""
        valid_frames = None
        if lengths is not None:
            noisy = _reflect_fix_tail(noisy, lengths, self.n_fft, self.hop)
            valid_frames = 1 + lengths // self.hop
        return (*stft_split(noisy, self.n_fft, self.hop, self.win), valid_frames)

    # -- modes (each takes [B, L] on the engine's device, returns [B, L]) -----

    @torch.inference_mode()
    def mag_complex_full_band_crm_mask(self, noisy: torch.Tensor,
                                       lengths: torch.Tensor | None = None) -> torch.Tensor:
        """The shipped default: the three-view model -> full-band cIRM
        (inferencer.py:140-165)."""
        mag, real, imag, valid_frames = self._spectrum(noisy, lengths)
        crm = self._model(mag[:, None], real[:, None], imag[:, None], valid_frames=valid_frames)
        return _crm_to_wave(crm.permute(0, 2, 3, 1), real, imag, noisy.shape[-1], self.n_fft,
                            self.hop, self.win, valid_frames=valid_frames)

    @torch.inference_mode()
    def full_band_crm_mask(self, noisy: torch.Tensor,
                           lengths: torch.Tensor | None = None) -> torch.Tensor:
        """A magnitude-only model (FullSubNet) -> full-band cIRM
        (inferencer.py:116-138)."""
        mag, real, imag, valid_frames = self._spectrum(noisy, lengths)
        crm = self._model(mag[:, None], valid_frames=valid_frames)
        return _crm_to_wave(crm.permute(0, 2, 3, 1), real, imag, noisy.shape[-1], self.n_fft,
                            self.hop, self.win, valid_frames=valid_frames)

    @torch.inference_mode()
    def sub_band_crm_mask(self, noisy: torch.Tensor,
                          lengths: torch.Tensor | None = None) -> torch.Tensor:
        """A sub-band model on the folded batch (inferencer.py:84-114): the
        magnitude unfolded to [B*F, 2 n_neighbor + 1, T] with the config's
        `pad_mode`, the model's cIRM [B*F, 2, T] decompressed with the
        reference's limit of 9.99 (not the shared 9.9, inferencer.py:104-106).
        With `lengths`, each utterance's frame count repeats over its fold
        rows and reaches the model as `valid_frames`."""
        pad_mode = self.inference_args.get("pad_mode", "reflect")
        mag, real, imag, valid_frames = self._spectrum(noisy, lengths)
        batch, num_freqs, frames = mag.shape
        unfolded = freq_unfold(mag[:, None], self.n_neighbor, pad_mode).reshape(
            batch * num_freqs, 2 * self.n_neighbor + 1, frames)
        kwargs = {}
        if valid_frames is not None:
            kwargs["valid_frames"] = valid_frames.repeat_interleave(num_freqs)
        crm = self._model(unfolded, **kwargs).reshape(batch, num_freqs, 2, frames)
        crm = decompress_cirm(crm.permute(0, 1, 3, 2), limit=9.99)
        real, imag = complex_mul(real, imag, crm[..., 0], crm[..., 1])
        if valid_frames is not None:
            mask = time_mask(frames, valid_frames, real.dtype)[:, None, :]
            real, imag = real * mask, imag * mask
        return istft(real, imag, self.n_fft, self.hop, self.win, length=noisy.shape[-1],
                     valid_frames=valid_frames)

    @torch.inference_mode()
    def complex_full_band_crm_mask(self, noisy: torch.Tensor) -> torch.Tensor:
        """A model of the stacked [real, imag] two-channel spectrum ->
        full-band cIRM (inferencer.py:167-189)."""
        _, real, imag, _ = self._spectrum(noisy, None)
        crm = self._model(torch.stack([real, imag], dim=1))
        return _crm_to_wave(crm.permute(0, 2, 3, 1), real, imag, noisy.shape[-1], self.n_fft,
                            self.hop, self.win)

    @torch.inference_mode()
    def mag(self, noisy: torch.Tensor) -> torch.Tensor:
        """A model of the magnitude that returns the enhanced magnitude,
        resynthesized with the noisy phase (inferencer.py:56-66)."""
        mag, real, imag, _ = self._spectrum(noisy, None)
        enhanced = self._model(mag[:, None])[:, 0]
        _, phase = mag_phase(torch.complex(real, imag))
        return istft(enhanced, phase, self.n_fft, self.hop, self.win, length=noisy.shape[-1],
                     use_mag_phase=True)

    @torch.inference_mode()
    def scaled_mask(self, noisy: torch.Tensor) -> torch.Tensor:
        """A real scaling mask (the model's first channel) on the complex
        spectrum (inferencer.py:68-82)."""
        mag, real, imag, _ = self._spectrum(noisy, None)
        mask = self._model(mag[:, None])[:, 0]
        return istft(real * mask, imag * mask, self.n_fft, self.hop, self.win,
                     length=noisy.shape[-1])

    @torch.inference_mode()
    def time_domain(self, noisy: torch.Tensor) -> torch.Tensor:
        """A waveform-to-waveform model (inferencer.py:252-256)."""
        return self._model(noisy)

    def overlapped_chunk(self, noisy, chunk_seconds: int | None = None,
                         chunk_batch: int = 8) -> torch.Tensor:
        """One long utterance [1, L] in Hann-overlapped chunks
        (inferencer.py:191-250, single-channel form): chunks of
        `chunk_seconds` (the config's `chunk_length`, 4 s by default) with a
        hop of half a chunk and 256 samples of noisy pre-context each,
        cross-faded 50 %. Every chunk goes through the length-aware base mode
        (the model family's full-band cIRM mode) at one fixed shape
        [chunk_batch, 256 + chunk]: the tail chunk is zero-padded and carries
        its true length, and a partial last group repeats row 0, whose
        outputs are dropped. Returns [1, L] on the CPU."""
        if chunk_seconds is None:
            chunk_seconds = self.inference_args.get("chunk_length", 4)
        y = noisy.cpu().numpy() if isinstance(noisy, torch.Tensor) else np.asarray(noisy)
        if y.ndim != 2 or y.shape[0] != 1:
            raise ValueError("overlapped_chunk enhances one utterance [1, L] at a time")
        y = y[0].astype(np.float32)
        chunk_length = int(self.sr * chunk_seconds)
        hop = chunk_length // 2
        num_chunks = int(len(y) / hop) + 1
        window = np.hanning(chunk_length + 1)[:chunk_length].astype(np.float32)
        base = getattr(self, "mag_complex_full_band_crm_mask" if self.model_def.n_inputs == 3
                       else "full_band_crm_mask")
        in_len = 256 + chunk_length

        rows, lens = [], []  # the reference loop's chunks, on the host
        for idx in range(num_chunks):
            start = idx * hop
            content = y[start:start + chunk_length]
            if len(content) == 0:  # a pad-only tail: the reference yields nothing
                break
            row = np.zeros(in_len, np.float32)
            if idx > 0:
                row[:256] = y[start - 256:start]
            row[256:256 + len(content)] = content
            rows.append(row)
            lens.append(256 + len(content))

        enhanced_rows = []
        for s in range(0, len(rows), chunk_batch):
            group, group_lens = rows[s:s + chunk_batch], lens[s:s + chunk_batch]
            n_real = len(group)
            group += [rows[0]] * (chunk_batch - n_real)  # outputs dropped
            group_lens += [lens[0]] * (chunk_batch - n_real)
            out = base(torch.as_tensor(np.stack(group), device=self.device),
                       torch.as_tensor(group_lens, device=self.device)).cpu().numpy()
            enhanced_rows += [out[j, 256:lens[s + j]] for j in range(n_real)]

        # the reference's Hann OLA (inferencer.py:218-243): the first chunk's
        # first half passes unwindowed; every later chunk is windowed and its
        # first half cross-fades with the previous chunk's second half
        prev, segments = None, []
        for idx, enhanced in enumerate(enhanced_rows):
            if idx == 0:
                cur = enhanced[:hop]
                prev = enhanced[hop:] * window[hop:][:max(0, len(enhanced) - hop)]
            else:
                enhanced = enhanced * window[:len(enhanced)]
                tmp = enhanced[:hop]
                n = min(len(tmp), len(prev))
                cur = tmp[:n] + prev[:n]
                prev = enhanced[hop:]
            segments.append(cur)
        full = np.concatenate(segments) if segments else np.zeros_like(y)
        return torch.from_numpy(np.ascontiguousarray(full[:len(y)][None]))
