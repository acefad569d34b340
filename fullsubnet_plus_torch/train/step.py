"""The training and evaluation steps (the reference trainer's hot loop).

Counterpart of fullsubnet_plus_tpu/train/step.py:33-193 and :273-402
(reference trainer.py:322-351, :364-427): STFT of both waveforms on the
device, the compressed cIRM target with `drop_band`, the model forward with
`training=True` (the matching `drop_band` inside), the loss, a clip of the
gradients' global norm and an Adam update. On the card the sub-band LSTM's
forward and backward run through the kernels of ops/lstm2_train.py.

In PyTorch's idiom: the parameters are an nn.Module's float32 masters, the
Adam moments lie beside them in the `TrainState` as one flat tensor each,
and a step updates the state in place (the JAX step donates its state's
buffers to the same end). The optimizer works on the flattened gradients
and parameters, so its cost is a few dozen launches whatever the number of
parameter tensors. Clip
and Adam follow optax's arithmetic, since the port is held against the JAX
step: the clip scales by max_norm / norm only when the norm reaches
max_norm, and Adam divides by sqrt(nu_hat) + eps with both bias
corrections. Steps run on CUDA unless the caller asks for the CPU.

Every step takes FullSubNet+ (three spectrogram views) and FullSubNet
(the magnitude alone, `_forward_fullsubnet` of the JAX module). FullSubNet
trains both its LSTMs through the kernels, as the JAX model's `fast=True`
does: the full-band one at N = B, D 257, H 512, O 257 and the sub-band one
after `drop_band` at N = B F / 2, D 32, H 384, O 2.
`make_joint_mask_train_step` and `make_residual_train_step` (the
reference's `Trainer` and `Residual_Trainer` losses, JAX train/step.py:
195-270) take the forward as a function of the module; like JAX's they
have no non-finite select.

Under a mesh (parallel/mesh.py) the train step is data-parallel with JAX's
multi-process batch semantics, one card a rank: each rank feeds its own
rows; the loss is the mean over the global batch and the gradient the mean
of the ranks'. Each rank's rows keep their global row offset for
`drop_band`. The ranks agree through ONE all_reduce of the flat gradient with the loss
and a stop flag appended, before the norm, the clip and Adam, so the
non-finite select decides alike and the parameters stay bit-identical on
every rank. The counterpart of `stacked_lstm2_train_sharded` is this step:
each rank sweeps only its own fold rows, and the all_reduce sums the
weight gradients. A training mesh of several cards in one process, or with
a 'freq' axis, is not ported (ROADMAP.md Queue 1 item 12). `make_bucketed_eval_step(mesh=)` splits the
rows over this process's cards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fullsubnet_plus_torch.device import not_ported, resolve_device
from fullsubnet_plus_torch.dsp.mask import (
    build_complex_ideal_ratio_mask,
    build_ideal_ratio_mask,
)
from fullsubnet_plus_torch.dsp.norms import time_mask
from fullsubnet_plus_torch.dsp.stft import stft_split
from fullsubnet_plus_torch.dsp.unfold import drop_band
from fullsubnet_plus_torch.enhance import _crm_to_wave, _reflect_fix_tail
from fullsubnet_plus_torch.parallel.mesh import (
    all_reduce_sum_,
    check_mesh,
    data_sharding,
    replicated,
    row_offset,
    sync_replicas,
)


@dataclasses.dataclass
class AdamState:
    """Adam's step count (int32 scalar) and moments. Each moment is ONE flat
    float32 tensor on the model's device, the parameters' moments laid end
    to end in `named_parameters` order, so that a step updates all of them
    with a handful of launches instead of a few per parameter."""

    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def _flatten(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])


def _unflatten(flat: torch.Tensor, like) -> list:
    """Views of `flat`, one per tensor of `like`, in its shapes."""
    like = list(like)
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in like]), like)]


@dataclasses.dataclass
class TrainState:
    """The model (float32 master parameters), the optimizer's state and the
    number of steps taken (int32 scalar on the device; it also counts
    skipped steps). `make_train_step`'s step updates it in place."""

    model: nn.Module
    opt_state: AdamState
    step: torch.Tensor

    def state_dict(self) -> dict:
        """{"params", "mu", "nu": reference-layout dicts of CPU tensors;
        "count", "step": ints}: the form io/convert.py carries to and from
        the JAX package's TrainState."""
        names, params = zip(*self.model.named_parameters())

        def cpu(tensors):
            return {k: v.detach().cpu().clone() for k, v in zip(names, tensors)}

        return {"params": cpu(params), "mu": cpu(_unflatten(self.opt_state.mu, params)),
                "nu": cpu(_unflatten(self.opt_state.nu, params)),
                "count": int(self.opt_state.count), "step": int(self.step)}

    def load_state_dict(self, state: dict) -> "TrainState":
        self.model.load_state_dict(state["params"], strict=True)
        names, params = zip(*self.model.named_parameters())
        for key, flat in (("mu", self.opt_state.mu), ("nu", self.opt_state.nu)):
            if set(state[key]) != set(names):
                raise KeyError(f"{key} keys do not match the model's parameters")
            for name, view in zip(names, _unflatten(flat, params)):
                view.copy_(state[key][name])
        self.opt_state.count.fill_(state["count"])
        self.step.fill_(state["step"])
        return self


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam behind a global-norm clip (config/train.toml:22-25), with the
    arithmetic of optax.chain(clip_by_global_norm, adam), on flat tensors."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    clip_grad_norm: float = 10.0
    eps: float = 1e-8

    def init(self, model: nn.Module) -> AdamState:
        flat = _flatten(model.parameters())
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=flat.device),
                         mu=torch.zeros_like(flat), nu=torch.zeros_like(flat))

    def update(self, grads: torch.Tensor, grad_norm: torch.Tensor, state: AdamState):
        """The flat float32 gradients and their global norm -> (updates, new
        count, new mu, new nu), all new tensors: the caller decides whether
        to keep them. Nothing here reads a value back to the host."""
        clipped = torch.where(grad_norm < self.clip_grad_norm, grads,
                              (grads / grad_norm) * self.clip_grad_norm)
        mu = (1 - self.beta1) * clipped + self.beta1 * state.mu
        nu = (1 - self.beta2) * (clipped * clipped) + self.beta2 * state.nu
        count = state.count + 1
        steps = count.to(torch.float32)
        correction1 = 1 - torch.pow(torch.full_like(steps, self.beta1), steps)
        correction2 = 1 - torch.pow(torch.full_like(steps, self.beta2), steps)
        updates = -self.lr * ((mu / correction1) / (torch.sqrt(nu / correction2) + self.eps))
        return updates, count, mu, nu


def make_optimizer(lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
                   clip_grad_norm: float = 10.0) -> Optimizer:
    return Optimizer(lr, beta1, beta2, clip_grad_norm)


def init_train_state(model: nn.Module, optimizer: Optimizer, device="cuda") -> TrainState:
    """Move `model` (float32) to `device` and start the optimizer on it."""
    device = resolve_device(device)
    model = model.to(device=device, dtype=torch.float32)
    return TrainState(model, optimizer.init(model),
                      torch.zeros((), dtype=torch.int32, device=device))


def _to_device(array, device, dtype=torch.float32) -> torch.Tensor:
    if not isinstance(array, torch.Tensor):
        array = np.asarray(array)
    return torch.as_tensor(array, device=device).to(dtype)


def _forward(model, mag, real, imag, training, compute_dtype=torch.float32,
             valid_frames=None, n_inputs=3, rows=None):
    """The model on [B, F, T] views (the magnitude alone for a one-view
    model, `n_inputs` 1), with its parameters and inputs cast to
    `compute_dtype` where that is not float32 (the masters stay float32 and
    the cast is differentiated through, so gradients arrive in float32).
    `rows` (row_offset, global_batch) places a training batch in the
    global one, for `drop_band`."""
    views = [v[:, None].to(compute_dtype) for v in (mag, real, imag)[:n_inputs]]
    kwargs = {"valid_frames": valid_frames, "training": training}
    if rows is not None:
        kwargs["row_offset"], kwargs["global_batch"] = rows
    if compute_dtype == torch.float32:
        return model(*views, **kwargs)
    cast = {k: p.to(compute_dtype) for k, p in model.named_parameters()}
    return torch.func.functional_call(model, cast, tuple(views), kwargs)


def _mesh_devices(mesh) -> list:
    """The cards of a mesh, each resolved (a CUDA mesh without CUDA raises)."""
    check_mesh(mesh)
    for dev in mesh.devices.ravel():
        resolve_device(dev)
    return mesh.data_devices


def _model_replicas(mesh, fold=None):
    """A function model -> [one copy per 'data' card of `mesh`], made once
    per model (each copy's fold split over the cards of the `fold` axes)
    and synced from the model at every call."""
    cache = {}

    def replicas(model):
        if cache.get("model") is not model:
            cache["model"], cache["replicas"] = model, replicated(mesh, model)
            if fold:
                for i, replica in enumerate(cache["replicas"]):
                    replica.shard_fold(mesh.fold_devices(i, fold))
        sync_replicas(cache["replicas"])
        return cache["replicas"]

    return replicas


def _check_full_float32(compute_dtype, device: torch.device) -> None:
    """The float32 step on the card runs its matmuls in full float32, as
    the Enhancer's float32 path does; TF32 keeps about 3 digits. Every model
    variant's float32 work outside the kernels is matmuls and elementwise
    ops (the convolutions are matmuls and shifted multiply-adds, the plain
    recurrences and TSSE_ATT's attention matmuls): no cuDNN call, so the
    matmul flag is the one to hold."""
    if (compute_dtype == torch.float32 and device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the float32 train step needs full-precision matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")


def make_train_step(model_def, config, optimizer: Optimizer, loss_fn, *, n_fft: int = 512,
                    hop_length: int = 256, win_length: int = 512,
                    compute_dtype=torch.float32, mesh=None, remat: bool = False,
                    skip_nonfinite: bool = True, device="cuda"):
    """Build the (state, noisy [B, L], clean [B, L]) -> (state, metrics) step.

    `remat=True` recomputes the model forward in the backward
    (torch.utils.checkpoint) to save activation memory.

    A float32 step on the card refuses to build or run while
    `torch.backends.cuda.matmul.allow_tf32` is set.

    `skip_nonfinite=True` (default): when the loss, the gradients' global
    norm or the update's is NaN or Inf, the whole update (parameters and
    moments and Adam's count) is rejected by a select on a device-side flag,
    the step counter still advances and metrics["skipped"] is 1.0. Nothing
    in the step reads a value back to the host; the metrics ("loss",
    "grad_norm", "skipped") are device tensors.

    `mesh=` (parallel.Mesh, one card a rank) makes the step data-parallel
    across the ranks: (state, noisy, clean, stop=False) with this rank's
    rows of the global batch; the state lies on the mesh's card and
    `device` is not used. `stop` (this rank's preemption flag) rides in the
    gradient all_reduce, and under a process group metrics["stop"] is the
    number of ranks that set it, the same on every rank. A mesh of several
    cards in one process raises NotImplementedError (ROADMAP.md Queue 1
    item 12).
    """
    if mesh is not None:
        data_devices = _mesh_devices(mesh)
        if mesh.local_data > 1 or mesh.shape["freq"] > 1:
            raise not_ported(f"a training mesh of {mesh.devices.size} cards in one process "
                             "(training runs one rank per card)", "Queue 1 item 12")
        device = data_devices[0]
    device = resolve_device(device)
    _check_full_float32(compute_dtype, device)
    num_groups = config.num_groups_in_drop_band
    n_inputs = model_def.n_inputs

    def loss_value(model, noisy, clean, rows=None):
        """The loss of `model` on a batch; `rows` (row_offset, global_batch)
        places it in the global batch."""
        offset, total = rows if rows is not None else (0, None)
        noisy_mag, noisy_real, noisy_imag = stft_split(noisy, n_fft, hop_length, win_length)
        _, clean_real, clean_imag = stft_split(clean, n_fft, hop_length, win_length)
        cirm = build_complex_ideal_ratio_mask(noisy_real, noisy_imag, clean_real, clean_imag)
        cirm = drop_band(cirm.permute(0, 3, 1, 2), num_groups, offset, total).permute(0, 2, 3, 1)

        def forward(mag, real, imag):
            return _forward(model, mag, real, imag, True, compute_dtype, n_inputs=n_inputs,
                            rows=rows)

        if remat:
            crm = checkpoint(forward, noisy_mag, noisy_real, noisy_imag, use_reentrant=False)
        else:
            crm = forward(noisy_mag, noisy_real, noisy_imag)
        return loss_fn(cirm, crm.permute(0, 2, 3, 1).float())

    def data_parallel_grads(model, noisy, clean, stop):
        """(mean flat gradient, mean loss, stop count) over the global
        batch: this rank's gradient, then one all_reduce of [gradient |
        loss | stop] over the ranks."""
        rows = noisy.shape[0]
        noisy, clean = (_to_device(a, device) for a in (noisy, clean))
        with torch.enable_grad():
            loss = loss_value(model, noisy, clean,
                              rows=(row_offset(mesh, rows), rows * mesh.process_count))
            grads = _flatten(torch.autograd.grad(loss, list(model.parameters())))
        flag = torch.full((1,), float(bool(stop)), device=device)
        buffer = all_reduce_sum_(torch.cat([grads, loss.detach().reshape(1), flag]), mesh)
        return buffer[:-2] / mesh.process_count, buffer[-2] / mesh.process_count, buffer[-1]

    def train_step(state: TrainState, noisy, clean, stop: bool = False):
        _check_full_float32(compute_dtype, device)
        params = list(state.model.parameters())
        if params[0].device.type != device.type:
            raise ValueError(f"the state lies on {params[0].device}, the step on {device}")
        metrics = {}
        if mesh is None:
            noisy, clean = (_to_device(a, params[0].device) for a in (noisy, clean))
            with torch.enable_grad():
                loss = loss_value(state.model, noisy, clean)
                grads = _flatten(torch.autograd.grad(loss, params))
        else:
            grads, loss, stops = data_parallel_grads(state.model, noisy, clean, stop)
            if mesh.group is not None:
                metrics["stop"] = stops
        metrics.update(_apply_update(state, params, grads, loss, optimizer, skip_nonfinite))
        return state, metrics

    return train_step


@torch.no_grad()
def _apply_update(state: TrainState, params, grads, loss, optimizer: Optimizer,
                  skip_nonfinite: bool) -> dict:
    """One clipped-Adam update of `params` (the state's model) from the flat
    gradient `grads`, in place, and step += 1; returns {"loss", "grad_norm"}
    and, with `skip_nonfinite`, "skipped" (the update rejected by a select
    on a device-side flag when the loss, the gradient norm or the update is
    NaN or Inf; the step counter still advances)."""
    loss, opt = loss.detach(), state.opt_state
    old = _flatten(params)
    grad_norm = torch.linalg.vector_norm(grads)
    updates, count, mu, nu = optimizer.update(grads, grad_norm, opt)
    new = old + updates
    metrics = {"loss": loss, "grad_norm": grad_norm}
    if skip_nonfinite:
        # the update itself must be finite too: m / (sqrt(v) + eps)
        # can overflow from finite gradients
        ok = (torch.isfinite(loss) & torch.isfinite(grad_norm)
              & torch.isfinite(torch.linalg.vector_norm(updates)))
        new, mu, nu = (torch.where(ok, a, b)
                       for a, b in ((new, old), (mu, opt.mu), (nu, opt.nu)))
        count = torch.where(ok, count, opt.count)
        metrics["skipped"] = 1.0 - ok.to(torch.float32)
    torch._foreach_copy_(params, _unflatten(new, params))
    opt.mu, opt.nu, opt.count = mu, nu, count
    state.step += 1
    return metrics


def _make_loss_step(loss_value, optimizer: Optimizer, device):
    """(state, noisy, clean) -> (state, {"loss", "grad_norm"}): the gradient
    of `loss_value(model, noisy, clean)` through `_apply_update`, with no
    non-finite select."""
    device = resolve_device(device)

    def train_step(state: TrainState, noisy, clean):
        _check_full_float32(torch.float32, device)
        params = list(state.model.parameters())
        noisy, clean = (_to_device(a, params[0].device) for a in (noisy, clean))
        with torch.enable_grad():
            loss = loss_value(state.model, noisy, clean)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = _flatten(torch.zeros_like(p) if g is None else g
                         for g, p in zip(grads, params))
        return state, _apply_update(state, params, grads, loss, optimizer, False)

    return train_step


def make_joint_mask_train_step(forward_fn, optimizer: Optimizer, loss_fn, *, alpha: float = 1.0,
                               num_groups: int = 2, n_fft: int = 512, hop_length: int = 256,
                               win_length: int = 512, device="cuda"):
    """The reference `Trainer`'s step (fullsubnet_plus/trainer/trainer.py:
    14-73): loss alpha MSE(cIRM, cRM) + (1 - alpha) MSE(IRM, RM), the cIRM
    target `drop_band`ed, the IRM target full-band, for a forward that
    returns the pair. `forward_fn(model, noisy_mag, noisy_real, noisy_imag)`
    ([B, F, T] each) -> (RM [B, 1, F, T], cRM [B, 2, F', T])."""

    def loss_value(model, noisy, clean):
        noisy_mag, noisy_real, noisy_imag = stft_split(noisy, n_fft, hop_length, win_length)
        clean_mag, clean_real, clean_imag = stft_split(clean, n_fft, hop_length, win_length)
        irm = build_ideal_ratio_mask(noisy_mag, clean_mag)  # [B, F, T, 1]
        cirm = build_complex_ideal_ratio_mask(noisy_real, noisy_imag, clean_real, clean_imag)
        cirm = drop_band(cirm.permute(0, 3, 1, 2), num_groups).permute(0, 2, 3, 1)
        rm, crm = forward_fn(model, noisy_mag, noisy_real, noisy_imag)
        return (alpha * loss_fn(cirm, crm.permute(0, 2, 3, 1))
                + (1.0 - alpha) * loss_fn(irm, rm.permute(0, 2, 3, 1)))

    return _make_loss_step(loss_value, optimizer, device)


def make_residual_train_step(forward_fn, optimizer: Optimizer, loss_fn, *, alpha: float = 1.0,
                             n_fft: int = 512, hop_length: int = 256, win_length: int = 512,
                             device="cuda"):
    """The reference `Residual_Trainer`'s step (trainer.py:160-225): loss
    alpha MSE(clean spectrum, enhanced) + (1 - alpha) MSE(cIRM, cIRM-hat),
    both complex as [.., 2], with no `drop_band` (the reference comments it
    out). `forward_fn(model, noisy_mag, noisy_real, noisy_imag)` -> (cIRM
    [B, 2, F, T], enhanced spectrum [B, 2, F, T])."""

    def loss_value(model, noisy, clean):
        noisy_mag, noisy_real, noisy_imag = stft_split(noisy, n_fft, hop_length, win_length)
        _, clean_real, clean_imag = stft_split(clean, n_fft, hop_length, win_length)
        cirm = build_complex_ideal_ratio_mask(noisy_real, noisy_imag, clean_real, clean_imag)
        clean_complex = torch.stack([clean_real, clean_imag], dim=-1)  # [B, F, T, 2]
        cirm_hat, enhanced = forward_fn(model, noisy_mag, noisy_real, noisy_imag)
        return (alpha * loss_fn(clean_complex, enhanced.permute(0, 2, 3, 1))
                + (1.0 - alpha) * loss_fn(cirm, cirm_hat.permute(0, 2, 3, 1)))

    return _make_loss_step(loss_value, optimizer, device)


def make_eval_step(model_def, config, loss_fn, *, n_fft: int = 512, hop_length: int = 256,
                   win_length: int = 512, device="cuda"):
    """Validation: (model, noisy [B, L], clean [B, L]) -> (loss without
    drop_band, enhanced waveform [B, L]) (reference trainer.py:364-427)."""
    device = resolve_device(device)
    n_inputs = model_def.n_inputs

    @torch.no_grad()
    def eval_step(model, noisy, clean):
        noisy, clean = _to_device(noisy, device), _to_device(clean, device)
        noisy_mag, noisy_real, noisy_imag = stft_split(noisy, n_fft, hop_length, win_length)
        _, clean_real, clean_imag = stft_split(clean, n_fft, hop_length, win_length)
        cirm = build_complex_ideal_ratio_mask(noisy_real, noisy_imag, clean_real, clean_imag)
        crm = _forward(model, noisy_mag, noisy_real, noisy_imag, False, n_inputs=n_inputs)
        crm = crm.permute(0, 2, 3, 1)
        enhanced = _crm_to_wave(crm, noisy_real, noisy_imag, noisy.shape[-1], n_fft,
                                hop_length, win_length)
        return loss_fn(cirm, crm), enhanced

    return eval_step


def make_bucketed_eval_step(model_def, config, loss_fn, *, n_fft: int = 512,
                            hop_length: int = 256, win_length: int = 512, mesh=None,
                            device="cuda"):
    """Batched, length-masked validation for bucket-padded utterances:
    (model, noisy [B, Lp], clean [B, Lp], lengths [B]) -> (losses [B],
    enhanced [B, Lp]); each row reproduces its exact-length batch-1 result
    (callers slice each row to its true length).

    The padded tail of both waveforms is rewritten with the reflection that
    torch.stft's center padding gives the exact-length run, the model masks
    its statistics over time to the valid frames, the loss is taken per row
    over the valid frames (exact for a mean of a pointwise loss: the masked
    region adds loss(0, 0) = 0, and the padded mean is rescaled by
    T_padded / T_valid), and the iSTFT normalizes with each row's own window
    envelope.

    `mesh=` (parallel.Mesh of this process's cards) splits the rows over
    its 'data' cards (they must divide), one copy of the model on each,
    synced from `model` at every call; with the config's `fold_sharding`
    naming 'freq' each shard's fold splits over its 'freq' cards. The
    results are gathered on the mesh's first card, where `model` lies."""
    if mesh is None:
        return _bucketed_eval(model_def, loss_fn, n_fft, hop_length, win_length,
                              resolve_device(device))
    data_devices = _mesh_devices(mesh)
    steps = [_bucketed_eval(model_def, loss_fn, n_fft, hop_length, win_length, dev)
             for dev in data_devices]
    replicas = _model_replicas(mesh, getattr(config, "fold_sharding", None))

    def mesh_eval_step(model, noisy, clean, lengths):
        outs = [step(replica, noisy[part], clean[part], np.asarray(lengths)[part])
                for step, replica, (_, part) in zip(steps, replicas(model),
                                                    data_sharding(mesh, len(noisy)))]
        return tuple(torch.cat([o[k].to(data_devices[0]) for o in outs]) for k in range(2))

    return mesh_eval_step


def _bucketed_eval(model_def, loss_fn, n_fft, hop_length, win_length, device):
    """`make_bucketed_eval_step`'s step on one device."""
    n_inputs = model_def.n_inputs

    @torch.no_grad()
    def eval_step(model, noisy, clean, lengths):
        noisy, clean = _to_device(noisy, device), _to_device(clean, device)
        lengths = _to_device(lengths, device, torch.int64)
        length = noisy.shape[-1]  # before the reflect-fix extension
        valid_frames = 1 + lengths // hop_length
        noisy_e = _reflect_fix_tail(noisy, lengths, n_fft, hop_length)
        clean_e = _reflect_fix_tail(clean, lengths, n_fft, hop_length)
        noisy_mag, noisy_real, noisy_imag = stft_split(noisy_e, n_fft, hop_length, win_length)
        _, clean_real, clean_imag = stft_split(clean_e, n_fft, hop_length, win_length)
        cirm = build_complex_ideal_ratio_mask(noisy_real, noisy_imag, clean_real, clean_imag)
        crm = _forward(model, noisy_mag, noisy_real, noisy_imag, False, valid_frames=valid_frames,
                       n_inputs=n_inputs).permute(0, 2, 3, 1)  # [B, F, T, 2]
        frames = crm.shape[2]
        tmask = time_mask(frames, valid_frames, crm.dtype)[:, None, :, None]
        losses = torch.stack([loss_fn(a, b) for a, b in zip(cirm * tmask, crm * tmask)])
        losses = losses * (frames / valid_frames.to(crm.dtype))
        enhanced = _crm_to_wave(crm, noisy_real, noisy_imag, length, n_fft, hop_length,
                                win_length, valid_frames=valid_frames)
        return losses, enhanced

    return eval_step
