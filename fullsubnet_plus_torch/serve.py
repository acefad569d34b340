"""Live multi-stream serving engine.

Counterpart of fullsubnet_plus_tpu/serve.py:1-331: the same chunk geometry
and Hann overlap-add as the reference's offline `overlapped_chunk` loop
(inferencer.py:191-250), for many concurrent live streams:

  * Each tick batches one ready chunk (4 s by default) from every active
    stream into one fixed-shape length-masked batch ([slots, 256 + chunk])
    of the Enhancer's base mode. More ready streams than slots take more
    dispatches per tick.
  * Fixed shapes only: a partial batch repeats row 0 (its outputs are
    dropped), and the tail chunk is zero-padded and carries its true length.
  * All stream state (pre-context, overlap-add halves) is host-side numpy;
    the device sees only the batched chunk tensor.

On a CUDA Enhancer a dispatch copies the batch to the card from pinned
memory, runs the mode, starts a non-blocking copy of the result into
pinned host memory and records a CUDA event behind it: a result is ready
when the event has passed, and finalizing it waits on the event. On the
CPU a result is ready as soon as the call returns.

`cli/serve.py` serves this over TCP. The engine itself is synchronous and
single-threaded: one engine per card.
"""

from __future__ import annotations

import numpy as np
import torch


class _Stream:
    def __init__(self):
        self.buffer = np.zeros(0, np.float32)  # un-chunked input audio
        self.base = 0              # absolute index of buffer[0] (prefix trimmed)
        self.received = 0          # total samples fed
        self.next_chunk = 0        # chunk index to dispatch next
        self.emitted_chunks = 0    # chunks whose output has been overlap-added
        self.inflight = 0          # chunks dispatched but not yet emitted
        self.prev_half = None      # windowed second half awaiting the cross-fade
        self.out = []              # enhanced segments ready to pull
        self.closed = False
        self.done = False
        self.failed = False        # the fetch of one of this stream's chunks died


class _Result:
    """One dispatch's [slots, in_len] output on its way to the host."""

    def __init__(self, out: torch.Tensor):
        self.event = None
        if out.device.type == "cuda":
            # the copy runs on the current stream of the result's own card,
            # which need not be the thread's current device (`cuda:N`); the
            # event must stand behind it on that stream
            with torch.cuda.device(out.device):
                self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                self.host.copy_(out, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host = out

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class StreamingEngine:
    """Chunked Hann-OLA enhancement for concurrent live streams.

    `enhancer`: an enhance.Enhancer, whose length-aware base mode is used;
    `slots`: device batch rows per dispatch; `chunk_samples`: 4 s at the
    enhancer's sample rate by default, with 50 % overlap and 256 samples of
    noisy pre-context per chunk (inferencer.py:197-217);
    `pipeline_depth`: dispatches left in flight before the oldest is
    fetched (0 fetches inline); `mode`: the base mode (the model family's
    full-band cIRM mode by default).
    """

    PRE_CONTEXT = 256  # noisy samples of left context per chunk

    def __init__(self, enhancer, slots: int = 8, chunk_samples: int | None = None,
                 pipeline_depth: int = 0, mode: str | None = None):
        self.enhancer = enhancer
        self.slots = int(slots)
        self.chunk = int(chunk_samples or 4 * enhancer.sr)
        if self.chunk % 2:
            raise ValueError(f"chunk_samples must be even, got {self.chunk}")
        self.hop = self.chunk // 2
        self.in_len = self.PRE_CONTEXT + self.chunk
        self.window = np.hanning(self.chunk + 1)[: self.chunk].astype(np.float32)
        # the base mode must be length-aware: the tail chunk is zero-padded
        # and carries its true length
        if mode is None:
            mode = ("mag_complex_full_band_crm_mask" if enhancer.model_def.n_inputs == 3
                    else "full_band_crm_mask")
        if mode not in enhancer.LENGTH_AWARE_MODES:
            raise ValueError(
                f"serving mode {mode!r} is not length-aware "
                f"({enhancer.LENGTH_AWARE_MODES}); the engine's zero-padded "
                "tail chunks need masked statistics")
        self.mode = mode
        self._base = getattr(enhancer, mode)
        self._streams: dict[int, _Stream] = {}
        self._next_id = 0
        # lifetime counters for the daemon's stats (cli/serve.py), never reset
        self.streams_opened = 0
        self.streams_completed = 0
        self.streams_aborted = 0
        self.streams_failed = 0
        self.chunks_enhanced = 0
        self.samples_out = 0
        # pipeline_depth > 0: results stay queued on their way to the host
        # and are collected when ready or when the window overflows, so the
        # copies and the compute of successive ticks overlap
        self.pipeline_depth = int(pipeline_depth)
        self._pending: list = []  # (_Result, [(stream, true_len), ...])

    def swap_enhancer(self, enhancer) -> None:
        """Serve a new model from the next dispatched chunk on (checkpoint
        hot-swap, cli/serve.py `--reload`). Chunks in flight finalize from
        the old model's outputs, later chunks run the new one, and the Hann
        cross-fade smooths the seam. The caller holds the serving lock and
        has warmed the new enhancer first (warmup() on a scratch engine)."""
        if enhancer.sr != self.enhancer.sr:
            raise ValueError("sample rate changed across reload")
        self.enhancer = enhancer
        self._base = getattr(enhancer, self.mode)

    def warmup(self) -> None:
        """Run the fixed-shape batch once before accepting traffic: on the
        card this builds the CUDA kernels of the path (nvcc, at first use)
        and sets up the CUDA context and cuFFT/cuBLAS plans, which must not
        happen inside a serving tick while clients wait. A kernel that does
        not build raises here."""
        rows = np.zeros((self.slots, self.in_len), np.float32)
        lens = np.full((self.slots,), self.in_len, np.int64)
        self._dispatch(rows, lens).numpy()

    def _dispatch(self, rows: np.ndarray, lens: np.ndarray) -> _Result:
        device = self.enhancer.device
        x, lengths = torch.from_numpy(rows), torch.from_numpy(lens)
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
            lengths = lengths.pin_memory().to(device, non_blocking=True)
        with torch.inference_mode():
            return _Result(self._base(x, lengths=lengths))

    # -- stream lifecycle ---------------------------------------------------

    def open(self) -> int:
        sid = self._next_id
        self._next_id += 1
        self._streams[sid] = _Stream()
        self.streams_opened += 1
        return sid

    def feed(self, sid: int, samples: np.ndarray) -> None:
        s = self._streams[sid]
        if s.closed:
            raise ValueError("feed() after close()")
        samples = np.asarray(samples, np.float32).reshape(-1)
        # trim the consumed prefix first: only chunk `next_chunk` onward is
        # read again (plus its pre-context), so a live stream's buffer stays
        # O(chunk) and feed() O(new samples)
        keep_from = max(0, s.next_chunk * self.hop - self.PRE_CONTEXT - s.base)
        if keep_from > 0:
            s.buffer = s.buffer[keep_from:]
            s.base += keep_from
        s.buffer = np.concatenate([s.buffer, samples])
        s.received += len(samples)

    def close(self, sid: int) -> None:
        """No more audio will arrive; remaining chunks flush on next tick."""
        self._streams[sid].closed = True

    def abort(self, sid: int) -> None:
        """Drop a stream outright (client gone): no further chunks are
        dispatched and its state is reaped now. Chunks in flight finalize
        into the orphaned object and are collected with it."""
        s = self._streams.pop(sid, None)
        if s is not None:
            s.closed = True
            s.done = True
            s.out = []
            self.streams_aborted += 1

    def pull(self, sid: int) -> np.ndarray:
        """Drain the enhanced audio produced so far (FIFO; may be empty). A
        finished stream is reaped once fully drained."""
        s = self._streams.get(sid)
        if s is None:
            return np.zeros(0, np.float32)
        out = np.concatenate(s.out) if s.out else np.zeros(0, np.float32)
        s.out = []
        if s.done:
            del self._streams[sid]
        return out

    def is_done(self, sid: int) -> bool:
        s = self._streams.get(sid)
        return s is None or (s.done and not s.out)

    def is_failed(self, sid: int) -> bool:
        """True if the fetch of one of this stream's chunks raised: its
        output is incomplete and will never finish, so the server aborts it
        (closes the connection without the completion frame)."""
        s = self._streams.get(sid)
        return s is not None and s.failed

    @property
    def active(self) -> int:
        return len(self._streams)

    # -- the serving tick ---------------------------------------------------

    def _ready_chunk(self, s: _Stream):
        """The next chunk's input row and true length, or None if not ready.

        Chunk i covers y[i*hop : i*hop + chunk] with 256 samples of noisy
        pre-context (zeros for chunk 0), inferencer.py:197-217. A chunk is
        ready when its content has arrived, or the stream is closed (the
        partial tail). A closed stream whose next chunk would start at or
        past its end yields nothing, as the reference loop stops there."""
        start = s.next_chunk * self.hop
        if start >= s.received:
            return None
        content_end = start + self.chunk
        if content_end > s.received:
            if not s.closed:
                return None
            content_end = s.received
        row = np.zeros(self.in_len, np.float32)
        rel = start - s.base  # buffer holds [base, received)
        if s.next_chunk > 0:
            row[: self.PRE_CONTEXT] = s.buffer[rel - self.PRE_CONTEXT: rel]
        row[self.PRE_CONTEXT: self.PRE_CONTEXT + (content_end - start)] = (
            s.buffer[rel: content_end - s.base])
        return row, self.PRE_CONTEXT + (content_end - start)

    def _emit(self, s: _Stream, enhanced: np.ndarray) -> None:
        """The reference's Hann-OLA (inferencer.py:218-243): the first
        chunk's first half passes through unwindowed; later chunks are
        windowed and cross-faded with the saved second half."""
        if s.emitted_chunks == 0:
            s.out.append(enhanced[: self.hop].copy())
            tail = enhanced[self.hop:]
            s.prev_half = tail * self.window[self.hop:][: len(tail)]
        else:
            enhanced = enhanced * self.window[: len(enhanced)]
            head = enhanced[: self.hop]
            n = min(len(head), len(s.prev_half))
            s.out.append(head[:n] + s.prev_half[:n])
            s.prev_half = enhanced[self.hop:]
        s.emitted_chunks += 1
        self.samples_out += len(s.out[-1])

    def tick(self) -> int:
        """Dispatch one ready chunk of every stream that has one (`slots`
        rows per dispatch). Returns the number of chunks dispatched. Call
        every hop in live operation: a tick's wall time is the latency it
        adds."""
        self._collect(block=False)
        work = []  # (stream, row, true_len)
        for s in self._streams.values():
            if s.done:
                continue
            ready = self._ready_chunk(s)
            if ready is not None:
                work.append((s, *ready))
            elif s.closed and s.inflight == 0:
                self._finish(s)
        for group_start in range(0, len(work), self.slots):
            group = work[group_start: group_start + self.slots]
            rows = [w[1] for w in group]
            lens = [w[2] for w in group]
            while len(rows) < self.slots:  # fixed shape: repeat row 0
                rows.append(rows[0])
                lens.append(lens[0])
            out = self._dispatch(np.stack(rows), np.asarray(lens, np.int64))
            for s, _, _ in group:
                s.next_chunk += 1
                s.inflight += 1
            entry = (out, [(g[0], g[2]) for g in group])
            if self.pipeline_depth == 0:
                self._finalize(entry)  # fetch inline: lowest latency
            else:
                self._pending.append(entry)
                while len(self._pending) > self.pipeline_depth:
                    self._finalize(self._pending.pop(0))
        self._collect(block=False)
        return len(work)

    def _collect(self, block: bool) -> None:
        """Finalize queued dispatches in order; without `block`, stop at the
        first result the device has not produced yet."""
        while self._pending:
            out, _ = self._pending[0]
            if not block and not out.is_ready():
                return
            self._finalize(self._pending.pop(0))

    def _finalize(self, entry) -> None:
        out, refs = entry
        try:
            arr = out.numpy()  # waits for the copy to the host
        except Exception:
            # The chunk is lost. Without this its streams' inflight counts
            # never reach zero and their clients wait forever: mark every
            # affected stream failed (no further dispatches; the server
            # reaps it) and re-raise for the ticker's failure policy.
            for s, _ in refs:
                s.inflight -= 1
                s.failed = True
                s.done = True
                s.out = []
                self.streams_failed += 1
            raise
        for j, (s, true_len) in enumerate(refs):
            self._emit(s, arr[j, self.PRE_CONTEXT: true_len])
            s.inflight -= 1
            self.chunks_enhanced += 1
            if s.closed and s.inflight == 0 and self._ready_chunk(s) is None:
                self._finish(s)

    def _finish(self, s: _Stream) -> None:
        """End of stream. The emitted segments already total the stream's
        length, so the saved half is dropped, as the reference's assembly
        drops it (`enhanced_audio[:, :num_samples]`, inferencer.py:243)."""
        s.prev_half = None
        s.done = True
        self.streams_completed += 1

    def drain(self) -> None:
        """Tick until no stream has work left (offline completion)."""
        while self.tick():
            pass
        self._collect(block=True)
        for s in self._streams.values():
            if s.closed and not s.done and s.inflight == 0:
                self._finish(s)
