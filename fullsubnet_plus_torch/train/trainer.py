"""The experiment engine: the epoch loop, validation, checkpoints and the
best-model gate (reference BaseTrainer, audio_zen/trainer/base_trainer.py,
and Trainer_Finetune, fullsubnet_plus/trainer/trainer.py:307-444).

Counterpart of fullsubnet_plus_tpu/train/trainer.py. The step's arithmetic
lives in train/step.py (on the card: the sub-band LSTM through K2 and K4,
or K3 in bf16, and K1 in validation); this class owns the loop, the files
(checkpoints, logs, TensorBoard events) and the gate, the mean of STOI and
normalized WB-PESQ on the No_reverb split (base_trainer.py:296-302).

Beyond the reference: a non-finite step is rejected on the device and
counted; SIGTERM / SIGINT during `train()` checkpoint at the next step
boundary and return, so `-R` resumes; a CUDA runtime error in an epoch
checkpoints the last whole epoch and returns; a failed validation is logged
and training goes on; `heartbeat.json` is rewritten every
`heartbeat_interval` steps and `run_complete.json` marks a finished run for
train/supervisor.py. `history` keeps each epoch's losses, scores and host
timings (the epoch's wall, the time spent waiting on the loader, each
step's wall, validation's eval and metric time).

Under a mesh across ranks (parallel/mesh.py; one rank per card, each fed
its own shard of the clean list) the step is data-parallel and the ranks
keep in step: they agree each epoch's step count (the least of theirs)
before it starts, and a SIGTERM on any rank rides in the step's gradient
all_reduce, so every rank stops after the same step. Only the primary
rank (`is_primary`) writes checkpoints, TensorBoard events, the heartbeat
and `run_complete.json`, and only it validates; the score is broadcast, a
failure there as NaN, on which every rank raises (JAX trainer.py:350-377).
"""

from __future__ import annotations

import importlib.util
import json
import os
import signal
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fullsubnet_plus_torch.device import resolve_device
from fullsubnet_plus_torch.eval.metrics import compute_metric, metric_available, validation_score
from fullsubnet_plus_torch.io.checkpoint import CheckpointManager, load_torch_checkpoint
from fullsubnet_plus_torch.parallel.mesh import agreed_min, barrier, broadcast_float, check_mesh
from fullsubnet_plus_torch.train.loss import mse_loss
from fullsubnet_plus_torch.train.step import (
    init_train_state,
    make_bucketed_eval_step,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from fullsubnet_plus_torch.utils import logger

COMPUTE_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}
# unfetched losses the host may run ahead of the card: fetching each step's
# loss at once would wait for the step to finish before the next is queued
LOSS_WINDOW = 8


def _np_magspec(y, n_fft: int = 512, hop: int = 256) -> np.ndarray:
    """[F, T] magnitude spectrogram in numpy on the host, for TB figures."""
    y = np.pad(np.asarray(y, np.float64).reshape(-1), n_fft // 2, mode="reflect")
    n = max(1 + (len(y) - n_fft) // hop, 1)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    frames = y[idx] * np.hanning(n_fft + 1)[:-1][None, :]  # periodic Hann
    return np.abs(np.fft.rfft(frames, axis=1)).T


class Trainer:
    def __init__(self, model_def, model_config, *, save_dir: str, train_loader=None,
                 valid_dataset=None, loss_fn=None, optimizer=None, acoustics: dict | None = None,
                 epochs: int = 9999, save_checkpoint_interval: int = 1,
                 validation_interval: int = 1, validation_metrics=("STOI", "SI_SDR"),
                 metric_workers: int = 4, valid_batch_size: int = 8, valid_num_buckets: int = 2,
                 save_max_metric_score: bool = True, mesh=None, compute_dtype=None,
                 remat: bool = False, seed: int = 0, use_tensorboard: bool = True,
                 handle_preemption: bool = True, heartbeat_interval: int = 50,
                 lr: float | None = None, device="cuda", is_primary: bool | None = None):
        """`mesh` (parallel.Mesh, one card a rank): data-parallel training
        over its ranks; the model lies on its card and `device` is not used.
        `is_primary` (default: rank 0 of the mesh, or True) writes the
        files and validates."""
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")
        if mesh is not None:
            device = check_mesh(mesh).data_devices[0]
        if is_primary is None:
            is_primary = mesh is None or mesh.process_index == 0
        self.mesh = mesh
        self.is_primary = is_primary
        self.device = resolve_device(device)
        self.train_loader = train_loader
        self.valid_dataset = valid_dataset
        self.loss_fn = loss_fn or mse_loss
        self.optimizer = optimizer or make_optimizer()
        ac = acoustics or {}
        self.acoustics = {k: ac.get(k, v) for k, v in
                          (("n_fft", 512), ("hop_length", 256), ("win_length", 512))}
        self.sr = ac.get("sr", 16000)
        self.epochs = epochs
        self.save_checkpoint_interval = save_checkpoint_interval
        self.validation_interval = validation_interval
        self.validation_metrics = [m for m in validation_metrics if metric_available(m)]
        self.metric_workers = metric_workers
        # bucketed validation (valid_batch_size > 0): utterances sorted by
        # length into valid_num_buckets buckets, each zero-padded to its
        # longest and run length-masked in batches of valid_batch_size;
        # 0 selects the reference's one-utterance loop (trainer.py:383)
        self.valid_batch_size = valid_batch_size
        self.valid_num_buckets = max(1, valid_num_buckets)
        self.save_max_metric_score = save_max_metric_score

        self.ckpt = CheckpointManager(save_dir, is_primary=is_primary, lr=lr)
        self.start_epoch = 1
        self.best_score = -np.inf if save_max_metric_score else np.inf
        self.heartbeat_interval = max(1, heartbeat_interval)
        self.skipped_steps = 0
        self.history: list[dict] = []
        self._global_step = 0
        self._preempted = False  # this process's signal
        self._stop_agreed = False  # some rank's signal, read from a step's all_reduce
        self._prev_handlers = {}
        # installed by train() alone, so a Trainer built for resume() or
        # inspection never takes Ctrl+C
        self._handle_preemption = handle_preemption

        self.train_step = make_train_step(
            model_def, model_config, self.optimizer, self.loss_fn,
            compute_dtype=COMPUTE_DTYPES[compute_dtype], mesh=mesh, remat=remat,
            device=self.device, **self.acoustics)
        self.eval_step = make_eval_step(model_def, model_config, self.loss_fn,
                                        device=self.device, **self.acoustics)
        self.bucketed_eval_step = make_bucketed_eval_step(
            model_def, model_config, self.loss_fn, device=self.device, **self.acoustics)
        model = model_def.module_cls(model_config).init_weights(
            torch.Generator().manual_seed(seed))
        self.state = init_train_state(model, self.optimizer, device=self.device)

        self.writer = None
        self.visualization_n_samples = 3
        if use_tensorboard and is_primary:
            from fullsubnet_plus_torch.utils.tb_events import EventWriter

            self.writer = EventWriter(os.path.join(save_dir, "logs"))
        self._figures = importlib.util.find_spec("matplotlib") is not None

    def spec_audio_visualization(self, noisy, enhanced, clean, name, epoch, mark=""):
        """TB audio and a spectrogram triptych of a validation sample
        (base_trainer.py:236-261); the figure only where matplotlib is
        installed. A failure here is logged and never stops training."""
        if self.writer is None:
            return
        views = (("Noisy", noisy), ("Enhanced", enhanced), ("Clean", clean))
        try:
            for label, y in views:
                self.writer.add_audio(f"{mark}_Speech/{name}_{label}", y, epoch,
                                      sample_rate=self.sr)
            if not self._figures:
                return
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(3, 1, figsize=(6, 6))
            for ax, (label, y) in zip(axes, views):
                ax.imshow(20 * np.log10(_np_magspec(y) + 1e-8), origin="lower", aspect="auto",
                          cmap="magma")
                ax.set_title(label)
            fig.tight_layout()
            self.writer.add_figure(f"{mark}_Spectrogram/{name}", fig, epoch)
            plt.close(fig)
        except Exception:  # noqa: BLE001 - visualization must never stop training
            logger.log(f"[Val] visualization of {name} failed:\n{traceback.format_exc()}")

    # -- checkpoints ---------------------------------------------------------

    def resume(self):
        """-R: the whole train state from latest_model.npz (base_trainer.py:128-157)."""
        self.state, epoch, self.best_score = self.ckpt.resume(self.state)
        self.start_epoch = epoch + 1
        logger.log(f"Resumed from epoch {epoch} (best={self.best_score:.4f})")

    def preload(self, path: str):
        """-P: a weights-only warm start (base_trainer.py:111-126)."""
        with torch.no_grad():
            n = self.ckpt.preload_params(path, self.state.model)
        logger.log(f"Preloaded {n} parameter tensors from {path}")

    def resume_from_torch(self, path: str):
        """--from-torch: continue a reference PyTorch run, its weights and
        Adam's moments and count with it (base_trainer.py:128-157)."""
        state, meta = load_torch_checkpoint(path)
        self.state.load_state_dict(state)
        if "epoch" in meta:
            self.start_epoch = meta["epoch"] + 1
        if "best_score" in meta:
            self.best_score = meta["best_score"]
        logger.log(f"Resumed from torch checkpoint {path} "
                   f"(epoch={meta.get('epoch')}, step={state['step']})")

    # -- failure detection and preemption -------------------------------------

    def _on_preempt(self, signum, frame):
        del frame
        self._preempted = True
        logger.log(f"Signal {signum} received: will checkpoint and exit at the next step "
                   "boundary")

    def _write_heartbeat(self, epoch: int, loss: float):
        if not self.is_primary:
            return
        beat = {"epoch": epoch, "global_step": self._global_step,
                # strict JSON: a bare NaN would break JSON readers of other languages
                "loss": loss if np.isfinite(loss) else None,
                "skipped_steps": self.skipped_steps, "time": time.time()}
        path = os.path.join(self.ckpt.save_dir, "heartbeat.json")
        try:
            with open(path + ".tmp", "w") as f:
                json.dump(beat, f)
            os.replace(path + ".tmp", path)  # a watchdog never reads a torn file
        except OSError:
            logger.log(f"[Train] heartbeat not written:\n{traceback.format_exc()}")

    def _is_best(self, score: float) -> bool:
        """base_trainer.py:202-213."""
        better = (score >= self.best_score if self.save_max_metric_score
                  else score <= self.best_score)
        if better:
            self.best_score = score
        return better

    def _mark_complete(self):
        """The marker train/supervisor.py reads: the recovery paths return
        normally too, so an exit code cannot tell "finished" from
        "checkpointed for -R"."""
        if not self.is_primary:
            return
        path = os.path.join(self.ckpt.save_dir, "run_complete.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"epochs": self.epochs, "time": time.time()}, f)
        os.replace(path + ".tmp", path)

    # -- the loop ----------------------------------------------------------------

    @property
    def _distributed(self) -> bool:
        return self.mesh is not None and self.mesh.group is not None

    def train(self, only_validation: bool = False):
        self._preempted = self._stop_agreed = False
        if self.is_primary:
            try:  # a marker of an earlier finished run
                os.unlink(os.path.join(self.ckpt.save_dir, "run_complete.json"))
            except FileNotFoundError:
                pass
        if self._handle_preemption and threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev_handlers[sig] = signal.signal(sig, self._on_preempt)
        try:
            self._train_loop(only_validation)
            # no rank leaves before the primary's files are written: a
            # supervisor relaunching a rank reads them
            barrier(self.mesh)
        finally:
            for sig, handler in self._prev_handlers.items():
                signal.signal(sig, handler)
            self._prev_handlers = {}

    def _validation_score(self, epoch: int) -> float:
        """The validation epoch's gate score. Across ranks only the primary
        validates (the reference's rank-0 pattern, base_trainer.py:328-339)
        and broadcasts the score; a failure there is logged and broadcast as
        NaN, and every rank raises."""
        if not self._distributed:
            return self._validation_epoch(epoch)
        score = float("nan")
        if self.is_primary:
            try:
                score = self._validation_epoch(epoch)
            except Exception:  # noqa: BLE001 - logged; every rank raises below
                logger.log(f"[Val] epoch {epoch} failed on the primary rank:\n"
                           f"{traceback.format_exc()}")
        score = broadcast_float(score, self.mesh)
        if np.isnan(score):
            raise RuntimeError(f"validation epoch {epoch} failed on the primary rank")
        return score

    def _train_loop(self, only_validation: bool = False):
        for epoch in range(self.start_epoch, self.epochs + 1):
            if only_validation:
                # _is_best first: it updates the best score the save records
                is_best = self._is_best(self._validation_score(epoch))
                self.ckpt.save(self.state, epoch, self.best_score, is_best)
                self._mark_complete()
                return
            t0 = time.time()
            try:
                train_loss = self._train_epoch(epoch)
            except torch.AcceleratorError:
                # a lost or failed device: keep a resumable run. Shape and
                # type bugs are not AcceleratorError and still propagate.
                logger.log(f"[Train] epoch {epoch} ABORTED by a device runtime error; "
                           f"checkpointing and exiting for -R:\n{traceback.format_exc()}")
                try:
                    self.ckpt.save(self.state, epoch - 1, self.best_score, latest_only=True)
                except Exception:  # noqa: BLE001 - the device may be unreachable
                    logger.log("[Train] the checkpoint on failure failed too; resume from "
                               f"the last epoch's file:\n{traceback.format_exc()}")
                return
            logger.log(f"[Train] epoch {epoch} loss {train_loss:.6f} ({time.time() - t0:.1f}s)")
            if self.writer:
                self.writer.add_scalar("Loss/Train", train_loss, epoch)

            # across ranks the flag every rank read from the all_reduce, so
            # that all of them stop here or none
            if self._stop_agreed if self._distributed else self._preempted:
                # the interrupted epoch is saved as epoch - 1, so -R runs it again
                self.ckpt.save(self.state, epoch - 1, self.best_score, latest_only=True)
                self._write_heartbeat(epoch, train_loss)
                logger.log(f"Preempted during epoch {epoch}: checkpoint written, exiting "
                           "(resume with -R)")
                return

            if epoch % self.save_checkpoint_interval == 0:
                self.ckpt.save(self.state, epoch, self.best_score)
            if epoch % self.validation_interval == 0 and self.valid_dataset is not None:
                # the epoch's checkpoint is on disk: a failed validation
                # skips this round's gate and training goes on
                try:
                    score = self._validation_score(epoch)
                except Exception:  # noqa: BLE001 - logged; the run continues
                    logger.log(f"[Val] epoch {epoch} FAILED, continuing training:\n"
                               f"{traceback.format_exc()}")
                    continue
                if self._is_best(score):
                    self.ckpt.save(self.state, epoch, self.best_score, is_best=True)
        self._mark_complete()  # only when every epoch ran to its end

    def _train_epoch(self, epoch: int) -> float:
        """One epoch's steps. Losses are fetched LOSS_WINDOW steps late, so
        the host queues steps ahead of the card. Across ranks the epoch runs
        the least of the ranks' batch counts, and this rank's preemption
        flag goes into each step's all_reduce: every rank reads the
        reduced flag at the same fetch and stops after the same step."""
        distributed = self._distributed
        steps = agreed_min(len(self.train_loader), self.mesh) if distributed else None
        pending: deque = deque()
        loss_total, n_counted, last_loss = 0.0, 0, 0.0
        stop_seen = False
        record = {"epoch": epoch, "steps": 0, "skipped": 0, "loader_wait_s": 0.0,
                  "step_walls_ms": []}
        self.history.append(record)

        def fetch():
            nonlocal loss_total, n_counted, last_loss, stop_seen
            metrics = pending.popleft()
            loss, skipped = float(metrics["loss"]), float(metrics["skipped"])
            if float(metrics.get("stop", 0.0)) > 0:
                stop_seen = self._stop_agreed = True
            if skipped > 0:  # a rejected step's loss stays out of the mean
                self.skipped_steps += 1
                record["skipped"] += 1
                logger.log(f"[Guard] non-finite step rejected on the device (epoch {epoch}, "
                           f"total skipped {self.skipped_steps})")
            else:
                loss_total += loss
                n_counted += 1
                last_loss = loss

        t_epoch = t_step = time.perf_counter()
        batches = self.train_loader.epoch(epoch)
        try:
            while steps is None or record["steps"] < steps:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                record["loader_wait_s"] += time.perf_counter() - t_wait
                if batch is None:
                    break
                if distributed:
                    self.state, metrics = self.train_step(self.state, *batch,
                                                          stop=self._preempted)
                else:
                    self.state, metrics = self.train_step(self.state, *batch)
                pending.append(metrics)
                record["steps"] += 1
                self._global_step += 1
                if len(pending) > LOSS_WINDOW:
                    fetch()
                if self._global_step % self.heartbeat_interval == 0:
                    self._write_heartbeat(epoch, last_loss)
                now = time.perf_counter()
                record["step_walls_ms"].append((now - t_step) * 1e3)
                t_step = now
                # across ranks a local flag stops nothing until the reduced
                # one is fetched, the same step on every rank
                if stop_seen if distributed else self._preempted:
                    break
        finally:
            batches.close()  # stops the loader's producer when the loop leaves early
        while pending:
            fetch()
        record["wall_s"] = time.perf_counter() - t_epoch
        record["train_loss"] = loss_total / max(n_counted, 1)
        return record["train_loss"]

    def _validation_epoch(self, epoch: int) -> float:
        """Validation split by speech type (trainer.py:364-444); the No_reverb
        gate score. Bucketed unless valid_batch_size is 0. Across ranks
        `_validation_score` runs it on the primary alone."""
        if self.valid_batch_size:
            return self._validation_epoch_bucketed(epoch)
        return self._validation_epoch_per_utterance(epoch)

    def _validation_epoch_bucketed(self, epoch: int) -> float:
        """Utterances sorted by length into valid_num_buckets buckets, each
        zero-padded to its longest and run through the length-masked eval
        step in batches of valid_batch_size (each row equals its
        exact-length batch-1 run). A short last batch repeats its first row;
        the copies' outputs are dropped."""
        t0 = time.perf_counter()
        n = len(self.valid_dataset)
        items = [self.valid_dataset[i] for i in range(n)]
        lengths = np.array([len(it[0]) for it in items], np.int64)
        order = np.argsort(lengths, kind="stable")
        per_bucket = -(-n // self.valid_num_buckets)
        batch = self.valid_batch_size
        loss_by_type: dict = {}
        pairs_by_type: dict = {}
        eval_s, batches = 0.0, 0
        for b0 in range(0, n, per_bucket):
            bucket = order[b0 : b0 + per_bucket]
            bucket_len = int(lengths[bucket].max())
            for s0 in range(0, len(bucket), batch):
                group = bucket[s0 : s0 + batch]
                rows = [group[j] if j < len(group) else group[0] for j in range(batch)]
                noisy_b = np.zeros((batch, bucket_len), np.float32)
                clean_b = np.zeros((batch, bucket_len), np.float32)
                for j, src in enumerate(rows):
                    noisy_b[j, : lengths[src]] = items[src][0]
                    clean_b[j, : lengths[src]] = items[src][1]
                t_eval = time.perf_counter()
                losses, enhanced = self.bucketed_eval_step(self.state.model, noisy_b, clean_b,
                                                           lengths[rows].astype(np.int32))
                losses, enhanced = losses.cpu().numpy(), enhanced.cpu().numpy()
                eval_s += time.perf_counter() - t_eval
                batches += 1
                for j, src in enumerate(group):
                    noisy_i, clean_i, name, speech_type = items[src]
                    enh = enhanced[j, : lengths[src]]
                    loss_by_type.setdefault(speech_type, []).append(float(losses[j]))
                    if len(pairs_by_type.get(speech_type, ())) < self.visualization_n_samples:
                        self.spec_audio_visualization(noisy_i, enh, clean_i, name, epoch,
                                                      mark=speech_type)
                    pairs_by_type.setdefault(speech_type, []).append((clean_i, enh))
        logger.log(f"[Val] epoch {epoch} bucketed eval: {n} utterances, "
                   f"{self.valid_num_buckets} bucket(s) x batch {batch}, "
                   f"{time.perf_counter() - t0:.1f}s")
        return self._score_splits(loss_by_type, pairs_by_type, epoch,
                                  {"batches": batches, "eval_s": eval_s})

    def _validation_epoch_per_utterance(self, epoch: int) -> float:
        """The reference's loop: one utterance a step at its own length
        (trainer.py:364-444)."""
        loss_by_type: dict = {}
        pairs_by_type: dict = {}
        t0 = time.perf_counter()
        for i in range(len(self.valid_dataset)):
            noisy, clean, name, speech_type = self.valid_dataset[i]
            loss, enhanced = self.eval_step(self.state.model, noisy[None], clean[None])
            enhanced = enhanced[0].cpu().numpy()
            loss_by_type.setdefault(speech_type, []).append(float(loss))
            if len(pairs_by_type.get(speech_type, ())) < self.visualization_n_samples:
                self.spec_audio_visualization(noisy, enhanced, clean, name, epoch,
                                              mark=speech_type)
            pairs_by_type.setdefault(speech_type, []).append((clean, enhanced))
        return self._score_splits(loss_by_type, pairs_by_type, epoch,
                                  {"batches": len(self.valid_dataset),
                                   "eval_s": time.perf_counter() - t0})

    def _score_splits(self, loss_by_type: dict, pairs_by_type: dict, epoch: int,
                      timing: dict | None = None) -> float:
        """Metrics on the host (a thread pool) and TB scalars per split, then
        the gate score."""
        t0 = time.perf_counter()
        scores, losses, means_by_type = {}, {}, {}
        for speech_type, pairs in pairs_by_type.items():
            losses[speech_type] = float(np.mean(loss_by_type[speech_type]))
            logger.log(f"[Val] epoch {epoch} {speech_type} loss {losses[speech_type]:.6f}")
            if self.writer:
                self.writer.add_scalar(f"Loss/{speech_type}", losses[speech_type], epoch)
            means = {}
            with ThreadPoolExecutor(max_workers=self.metric_workers) as ex:
                for metric in self.validation_metrics:
                    values = list(ex.map(
                        lambda p, m=metric: compute_metric(m, p[0], p[1], sr=self.sr), pairs))
                    means[metric] = float(np.mean(values))
                    logger.log(f"[Val] epoch {epoch} {speech_type} {metric} "
                               f"{means[metric]:.4f}")
                    if self.writer:
                        self.writer.add_scalar(f"{metric}/{speech_type}", means[metric], epoch)
            means_by_type[speech_type] = means
            scores[speech_type] = validation_score(means) if means else -np.inf
        score = self._gate_score(scores)
        record = {"epoch": epoch, "losses": losses, "metrics": means_by_type, "score": score,
                  "metrics_s": time.perf_counter() - t0, **(timing or {})}
        if self.history and self.history[-1]["epoch"] == epoch:
            self.history[-1]["validation"] = record
        else:
            self.history.append({"epoch": epoch, "validation": record})
        return score

    def _gate_score(self, scores: dict) -> float:
        """The No_reverb split's score, looked up by name (trainer.py:444).
        Without that split (a custom corpus) the first split gates, with a
        warning; a real 0.0 No_reverb score gates as 0.0."""
        if not scores:
            return -np.inf
        if "No_reverb" in scores:
            return scores["No_reverb"]
        speech_type, score = next(iter(scores.items()))
        logger.log(f"[Val] WARNING: no No_reverb split in {sorted(scores)}; the best-model "
                   f"gate falls back to {speech_type!r}")
        return score

