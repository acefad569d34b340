"""Live streaming-enhancement server over TCP.

    python -m fullsubnet_plus_torch.cli.serve -C configs/inference.toml \
        -M checkpoint(.npz|.tar|.pth) [--port 7860] [--slots 8] \
        [--dtype int8] [--device cuda] [--chunk-seconds 4] [--tick 0.1] \
        [--max-tick-failures 5] [--stall-timeout 300] [--supervise N] \
        [--watch SECS]
    python -m fullsubnet_plus_torch.cli.serve --stats [--host H --port P]
    python -m fullsubnet_plus_torch.cli.serve --reload CKPT [--host H --port P]

Counterpart of fullsubnet_plus_tpu/cli/serve.py:1-875 (the reference has
no daemon; its closest surface is the offline overlapped_chunk loop,
inferencer.py:191-250): N concurrent client streams, one fixed-shape
length-masked batch on the card, the reference's Hann-OLA per stream
(serve.py StreamingEngine). One server per card. With no --dtype and no
compute_dtype in the config, it serves int8 (the LSTMs' recurrent products
in int8, ops/lstm2_int8.py). FullSubNet+ is served through
mag_complex_full_band_crm_mask, FullSubNet through full_band_crm_mask.

Wire protocol (stdlib only, length-prefixed frames `[u32 big-endian
len][payload]`):

  client -> server:  frame 0: JSON header, e.g. {"sr": 16000}
                     frames 1..: raw float32 PCM (any sizes)
                     empty frame: end of stream
  server -> client:  raw float32 PCM frames of enhanced audio as chunks
                     complete; empty frame after the last sample, then EOF.

Observability: a header of {"stats": true} instead returns ONE JSON frame
of serving stats (streams, chunks and audio seconds enhanced, busy-tick
latency p50/p90/p99, tick failures, kernel launches) and the completion
frame; `--stats` is the bundled query client.

Model update without downtime: a header of {"reload": "<ckpt-path>"} makes
the daemon build and warm a new engine for that checkpoint in the
requesting client's thread (serving continues on the old model), then swap
it in. Live streams pick up the new model from their next chunk, the Hann
cross-fade smoothing the seam. `--reload CKPT` is the bundled client;
`--watch SECS` polls the -M checkpoint and swaps whenever it changes.

The 4 s / 50 % chunk geometry adds about 2 s of latency (audio must arrive
before it is enhanced); the compute adds the tick wall, which the stats
report.

Shutdown: SIGTERM (or Ctrl-C) drains gracefully: in-flight device work
finalizes, every live stream's enhanced audio flushes, completed streams
get the completion frame and the rest the protocol's clean abort (EOF
without it), and the daemon exits 0, so a `--supervise` wrapper does not
relaunch it.
"""

from __future__ import annotations

import argparse
import collections
import ipaddress
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np


def _send_frame(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_frame(conn: socket.socket):
    header = _recv_exact(conn, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length == 0:
        return b""
    return _recv_exact(conn, length)


def _recv_exact(conn: socket.socket, n: int):
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def is_loopback(host: str) -> bool:
    """Whether every address `host` resolves to is a loopback one
    (127.0.0.0/8, ::1, or IPv4-mapped loopback such as ::ffff:127.0.0.1).
    A host that does not resolve, or the wildcard, is not."""
    try:
        infos = socket.getaddrinfo(host, None)
    except (OSError, UnicodeError):
        return False
    addresses = {ipaddress.ip_address(info[4][0].split("%", 1)[0]) for info in infos}

    def loopback(address):
        mapped = getattr(address, "ipv4_mapped", None)
        return (mapped or address).is_loopback

    return bool(addresses) and all(loopback(a) for a in addresses)


def _abort_conn(conn: socket.socket) -> None:
    """Tear a client connection down so the client observes EOF now:
    `shutdown()` sends the FIN and wakes a reader blocked in recv on either
    side, which `close()` alone does not."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


def kernel_launches() -> dict:
    """Launch counts of the port's CUDA kernels in this process."""
    from fullsubnet_plus_torch.ops import lstm2, lstm2_int8

    return {"lstm2_fwd": sum(lstm2.LAUNCHES.values()),
            "lstm2_int8_fwd": sum(lstm2_int8.LAUNCHES.values())}


class StreamServer:
    """TCP front end around a serve.StreamingEngine.

    One reader thread per client feeds the engine; one ticker thread
    dispatches batched chunks and sends enhanced audio back. One lock
    serializes all engine access: the device runs the batches one after
    another anyway.

    Failure policy: a tick that raises is survivable (a transient device
    error), but `max_tick_failures` consecutive failures mean the device
    or its context is lost, so the daemon closes every client connection
    and exits non-zero for a supervisor to relaunch. A ticker that stops
    completing iterations (wedged inside a device call) is caught by the
    `stall_timeout` watchdog in serve_forever. Streams do not survive a
    restart: a client sees EOF without the completion frame.
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 7860,
                 tick_interval: float = 0.1, log=print,
                 max_tick_failures: int = 5, stall_timeout: float = 300.0,
                 reload_fn=None, checkpoint_path: str | None = None,
                 allow_remote_reload: bool = False):
        self.engine = engine
        self.tick_interval = tick_interval
        self.log = log
        self.max_tick_failures = max_tick_failures
        self.stall_timeout = stall_timeout
        # checkpoint hot-swap ({"reload": path}): reload_fn builds a fresh
        # engine for a path; it is warmed in the requesting client's thread
        # and its enhancer swapped in under the serving lock
        self.reload_fn = reload_fn
        self.checkpoint_path = checkpoint_path
        self.reloads = 0
        self._reload_lock = threading.Lock()
        # The reload header is an unauthenticated control plane. On a
        # non-loopback bind, reloads are restricted to the -M checkpoint's
        # directory unless the operator passes --allow-remote-reload.
        self._reload_restricted = not allow_remote_reload and not is_loopback(host)
        self.exit_code = 0
        self._lock = threading.Lock()
        self._conns: dict[int, socket.socket] = {}  # sid -> client conn
        self._stop = threading.Event()
        self._term = threading.Event()  # graceful-shutdown request (SIGTERM)
        self._last_tick = time.monotonic()
        # stats: lifetime totals and a rolling window of busy-tick engine
        # latencies (ticks that dispatched at least one chunk)
        self._t_start = time.monotonic()
        self.ticks_total = 0
        self.tick_failures_total = 0
        self._busy_tick_s = collections.deque(maxlen=512)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]  # resolved if port was 0
        # only the accept and tick threads are joined; the per-client reader
        # threads are daemonic and untracked, so a long-running daemon does
        # not keep one Thread object per connection it ever served
        self._threads: list[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for target in (self._accept_loop, self._tick_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        self.log(f"[serve] listening on :{self.port} "
                 f"(slots={self.engine.slots}, chunk={self.engine.chunk})")

    def stop(self) -> None:
        self._stop.set()
        self._close_listener()
        for t in self._threads:
            t.join(timeout=10)

    def _close_listener(self) -> None:
        """Close the listening socket. `shutdown()` first wakes the accept
        thread blocked on it, which `close()` alone does not on Linux."""
        _abort_conn(self._sock)

    def request_shutdown(self) -> None:
        """Ask serve_forever to drain and exit 0 (the SIGTERM handler's
        body). Idempotent and safe from any thread or signal context."""
        self._term.set()

    def serve_forever(self) -> int:
        """Run until stopped; returns the process exit code (0 = clean
        shutdown, non-zero = the failure policy tripped).

        SIGTERM and Ctrl-C trigger a graceful shutdown (_graceful_drain)
        with exit code 0, so a supervisor treats an operator's kill as a
        clean stop, not a crash to relaunch."""
        self.start()
        import signal

        prev_term = None
        if threading.current_thread() is threading.main_thread():
            prev_term = signal.signal(signal.SIGTERM, lambda *_: self.request_shutdown())
        try:
            while not self._stop.is_set():
                if self._term.is_set():
                    self._graceful_drain()
                    self._stop.set()
                    break
                time.sleep(0.2)
                stalled = time.monotonic() - self._last_tick
                if self.stall_timeout and stalled > self.stall_timeout:
                    # the ticker is wedged inside a device call that will not
                    # return; it cannot be interrupted, so close everything
                    # and exit (its thread is daemonic)
                    self.log(f"[serve] ticker stalled {stalled:.0f}s > "
                             f"{self.stall_timeout:.0f}s: shutting down for "
                             "supervisor restart")
                    self.exit_code = 2
                    self._disconnect_all(lock_timeout=1.0)
                    self._stop.set()
        except KeyboardInterrupt:
            self._graceful_drain()
        finally:
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            self.stop()
        return self.exit_code

    def _graceful_drain(self, join_timeout: float = 10.0) -> None:
        """Drain and release every live stream cleanly (the SIGTERM path).

        1. Close the listening socket: no new streams.
        2. Stop and join the ticker (it sends on client sockets outside the
           engine lock; flushing at the same time would interleave two
           sendall()s on one connection).
        3. Run the engine dry (StreamingEngine.drain) and pull each
           stream's output.
        4. Send each client its remaining frames; a stream whose audio is
           complete gets the completion frame, every other the clean abort
           (EOF without it), never a cut mid-frame.

        If the ticker is wedged inside a device call (and may hold the lock
        for good), the bounded join fails and every connection is aborted
        without touching the engine: SIGTERM always ends the daemon."""
        self.log("[serve] graceful shutdown: draining in-flight work")
        self._close_listener()
        self._stop.set()  # ends the ticker loop at its next wait
        ticker_dead = True
        for t in self._threads:
            t.join(timeout=join_timeout)
            if t.is_alive():
                ticker_dead = False
        if not ticker_dead or not self._lock.acquire(timeout=join_timeout):
            self.log("[serve] ticker wedged during shutdown: aborting "
                     "streams without drain")
            # the reader threads still add and remove connections under the
            # lock: snapshot under it too, unless a wedged ticker holds it
            self._disconnect_all(lock_timeout=join_timeout)
            return
        try:
            try:
                self.engine.drain()
            except Exception as e:  # a device failure mid-drain: flush what we have
                self.log(f"[serve] drain failed (flushing what we have): {e!r}")
            conns = list(self._conns.items())
            self._conns.clear()
            flushes = [(sid, conn, self.engine.pull(sid), self.engine.is_done(sid))
                       for sid, conn in conns]
        finally:
            self._lock.release()
        for sid, conn, out, done in flushes:
            try:
                if len(out):
                    _send_frame(conn, out.astype(np.float32).tobytes())
                if done:
                    _send_frame(conn, b"")  # the stream truly completed
            except OSError:
                pass
            _abort_conn(conn)
        if flushes:
            done_n = sum(1 for f in flushes if f[3])
            self.log(f"[serve] released {len(flushes)} live stream(s) ({done_n} "
                     f"completed, {len(flushes) - done_n} cleanly aborted)")

    def _disconnect_all(self, lock_timeout: float | None = None) -> None:
        """Close every client connection without the completion frame:
        clients observe an aborted stream, not a completed one. With
        `lock_timeout` (the stall watchdog, whose wedged ticker may hold
        the serving lock for good) it goes ahead without the lock after
        that many seconds."""
        locked = self._lock.acquire(timeout=-1 if lock_timeout is None else lock_timeout)
        try:
            conns = list(self._conns.items())
            self._conns.clear()
        finally:
            if locked:
                self._lock.release()
        for _sid, conn in conns:
            _abort_conn(conn)
        if conns:
            self.log(f"[serve] aborted {len(conns)} client stream(s)")

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Point-in-time serving stats (JSON-serializable), served to any
        client whose header frame is {"stats": true}."""
        with self._lock:
            e = self.engine
            lat = sorted(self._busy_tick_s)

            def pct(p):
                return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1000, 2) if lat else None

            return {
                "uptime_s": round(time.monotonic() - self._t_start, 1),
                "active_streams": len(self._conns),
                "slots": e.slots,
                "chunk_samples": e.chunk,
                "mode": e.mode,
                "pipeline_depth": e.pipeline_depth,
                "device": str(e.enhancer.device),
                "streams_opened": e.streams_opened,
                "streams_completed": e.streams_completed,
                "streams_aborted": e.streams_aborted,
                "streams_failed": e.streams_failed,
                "chunks_enhanced": e.chunks_enhanced,
                "audio_seconds_out": round(e.samples_out / e.enhancer.sr, 1),
                "ticks": self.ticks_total,
                "tick_failures": self.tick_failures_total,
                "busy_tick_ms": {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
                                 "window": len(lat)},
                "kernel_launches": kernel_launches(),
                "checkpoint": self.checkpoint_path,
                "reloads": self.reloads,
            }

    def watch_checkpoint(self, path: str, interval: float = 10.0):
        """Poll `path` and hot-swap whenever the file changes (follow a
        training run's atomically published checkpoints). Uses the reload
        path (build and warm in the watcher thread, swap under the lock); a
        failed reload is logged, retried with exponential backoff (at most
        32x the interval) without another change, and watching continues.
        Returns the started daemon thread."""

        def _sig():
            try:
                st = os.stat(path)
                return (st.st_mtime_ns, st.st_size)
            except OSError:
                return None

        def _loop(last=_sig()):
            failures = 0
            while not self._stop.wait(interval * min(2 ** failures, 32)):
                sig = _sig()
                if sig is None or sig == last:
                    continue
                resp = self._handle_reload(path)
                if "error" in resp:
                    # `last` stays: the next poll retries this publish
                    failures += 1
                    retry_s = interval * min(2 ** failures, 32)
                    self.log(f"[serve] watch: reload failed, still serving the "
                             f"previous model (retry in {retry_s:g}s): {resp['error']}")
                    continue
                failures = 0
                # the pre-reload signature: a change during the reload is
                # picked up by the next poll
                last = sig

        t = threading.Thread(target=_loop, daemon=True)
        t.start()
        self.log(f"[serve] watching {path} (every {interval:g}s)")
        return t

    def _handle_reload(self, path: str) -> dict:
        """Checkpoint hot-swap: build and warm the new engine while the
        ticker serves the old one, then swap the enhancer under the serving
        lock. One reload at a time."""
        if self.reload_fn is None:
            return {"error": "reload not enabled on this server"}
        if self._reload_restricted:
            if not self.checkpoint_path:
                # no checkpoint to anchor the restriction to: refuse, rather
                # than take the working directory as the base
                return {"error": "reload refused: daemon is bound to a "
                        "non-loopback interface and has no serving "
                        "checkpoint path to restrict reloads to"}
            base = os.path.dirname(os.path.realpath(self.checkpoint_path))
            target = os.path.realpath(path)
            try:
                inside = base and os.path.commonpath([base, target]) == base
            except ValueError:  # different drives, or mixed absolute/relative
                inside = False
            if not inside:
                return {"error": "reload refused: daemon is bound to a non-loopback "
                        "interface, so reload paths are restricted to the serving "
                        f"checkpoint's directory ({base or '?'}); pass "
                        "--allow-remote-reload to disable this guard"}
        with self._reload_lock:
            t0 = time.perf_counter()
            self.log(f"[serve] reload requested -> {path}: building and warming "
                     "the new model (serving continues)")
            try:
                fresh = self.reload_fn(path)
                fresh.warmup()
            except Exception as e:
                self.log(f"[serve] reload failed: {e!r}")
                return {"error": repr(e)}
            with self._lock:
                self.engine.swap_enhancer(fresh.enhancer)
                self.checkpoint_path = path
                self.reloads += 1
                kept = len(self._conns)
            dt = round(time.perf_counter() - t0, 1)
            self.log(f"[serve] hot-swapped checkpoint -> {path} "
                     f"({dt}s build+warmup, {kept} live stream(s) kept)")
            return {"ok": True, "checkpoint": path, "warmup_s": dt, "streams_kept": kept}

    # -- internals ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # the listener was closed
            threading.Thread(target=self._client_loop, args=(conn, addr),
                             daemon=True).start()

    def _client_loop(self, conn: socket.socket, addr) -> None:
        sid = None
        try:
            header = _recv_frame(conn)
            if header is None:
                conn.close()
                return
            meta = json.loads(header.decode() or "{}")
            if meta.get("stats"):
                # one JSON frame, then the completion frame; no stream opened
                _send_frame(conn, json.dumps(self.stats()).encode())
                _send_frame(conn, b"")
                conn.close()
                return
            if meta.get("reload"):
                # hot-swap to a checkpoint path on the server's filesystem,
                # in this client's thread: the build never blocks the tick
                resp = self._handle_reload(str(meta["reload"]))
                _send_frame(conn, json.dumps(resp).encode())
                _send_frame(conn, b"")
                conn.close()
                return
            with self._lock:
                sid = self.engine.open()
                self._conns[sid] = conn
            self.log(f"[serve] stream {sid} from {addr} sr={meta.get('sr')}")
            while True:
                frame = _recv_frame(conn)
                if frame is None or frame == b"":
                    break
                samples = np.frombuffer(frame, np.float32)
                with self._lock:
                    self.engine.feed(sid, samples)
            with self._lock:
                self.engine.close(sid)
        except Exception as e:  # a bad client must not kill the server
            self.log(f"[serve] client {addr} error: {e!r}")
            if sid is not None:
                # reap the half-open stream
                with self._lock:
                    self.engine.abort(sid)
                    self._conns.pop(sid, None)
            try:
                conn.close()
            except OSError:
                pass

    def _tick_loop(self) -> None:
        failures = 0  # consecutive ticks that raised or lost a stream
        while not self._stop.is_set():
            t0 = time.perf_counter()
            aborted, finished, error = [], [], None
            try:
                with self._lock:
                    n_work = self.engine.tick()
                    if n_work:
                        self._busy_tick_s.append(time.perf_counter() - t0)
                    for sid, conn in list(self._conns.items()):
                        if self.engine.is_failed(sid):
                            # the fetch of this stream's chunk died: abort,
                            # closing without the completion frame
                            aborted.append((sid, conn))
                            del self._conns[sid]
                            self.engine.abort(sid)
                            continue
                        out = self.engine.pull(sid)
                        done = self.engine.is_done(sid)
                        if len(out) or done:
                            finished.append((sid, conn, out, done))
                    for sid, conn, out, done in finished:
                        if done:
                            del self._conns[sid]
            except Exception as e:
                error = e
            # one failed tick is survivable; max_tick_failures consecutive
            # ones mean a lost device: exit for a supervisor restart instead
            # of spinning while streams stall
            self.ticks_total += 1
            if error is not None or aborted:
                failures += 1
                self.tick_failures_total += 1
                why = repr(error) if error is not None else "stream fetch died"
                self.log(f"[serve] tick failure ({failures}/{self.max_tick_failures}): {why}")
            else:
                failures = 0
            self._close_aborted(aborted)
            if failures >= self.max_tick_failures:
                self.log("[serve] persistent tick failures: shutting down for "
                         "supervisor restart")
                self.exit_code = 1
                self._disconnect_all()
                self._stop.set()
                return
            # sends happen outside the engine lock
            for sid, conn, out, done in finished:
                try:
                    if len(out):
                        _send_frame(conn, out.astype(np.float32).tobytes())
                    if done:
                        _send_frame(conn, b"")
                        conn.close()
                        self.log(f"[serve] stream {sid} complete")
                except OSError:
                    pass  # client went away; engine state already reaped
            self._last_tick = time.monotonic()
            elapsed = time.perf_counter() - t0
            self._stop.wait(max(0.0, self.tick_interval - elapsed))

    def _close_aborted(self, aborted) -> None:
        for sid, conn in aborted:
            _abort_conn(conn)
            self.log(f"[serve] stream {sid} aborted (device failure)")


def build_engine(config: dict, checkpoint_path: str, slots: int,
                 compute_dtype: str | None, chunk_seconds: float,
                 pipeline_depth: int = 2, log=print, device: str = "cuda"):
    """A StreamingEngine over an Enhancer for `checkpoint_path` (a JAX
    `.npz` or a reference `.tar`/`.pth`). compute_dtype None means unset:
    the config's [inferencer.args] compute_dtype applies; an explicit
    "float32" is never overridden by the config."""
    from fullsubnet_plus_torch.cli.enhance import load_state_dict
    from fullsubnet_plus_torch.enhance import Enhancer
    from fullsubnet_plus_torch.models import get_model
    from fullsubnet_plus_torch.serve import StreamingEngine

    model_def = get_model(config["model"]["path"])
    model_config = model_def.make_config(config["model"]["args"])
    acoustics = config.get("acoustics", {})
    inferencer_cfg = config.get("inferencer", {})
    if compute_dtype is None:
        compute_dtype = inferencer_cfg.get("args", {}).get("compute_dtype")
    if compute_dtype == "float32":
        compute_dtype = None
    enhancer = Enhancer(
        model_def, model_config, load_state_dict(checkpoint_path),
        n_fft=acoustics.get("n_fft", 512),
        hop_length=acoustics.get("hop_length", 256),
        win_length=acoustics.get("win_length", 512),
        sr=acoustics.get("sr", 16000),
        n_neighbor=inferencer_cfg.get("args", {}).get("n_neighbor", 15),
        compute_dtype=compute_dtype,
        inference_args=inferencer_cfg.get("args", {}),
        device=device,
    )
    # Honor the config's inferencer type when it names a length-aware
    # per-chunk mode; "overlapped_chunk" (and unset) mean the engine's own
    # default, which is the live form of that mode.
    mode = None
    configured = inferencer_cfg.get("type")
    if configured and configured != "overlapped_chunk":
        if configured in Enhancer.LENGTH_AWARE_MODES:
            mode = configured
        else:
            log(f"[serve] config inferencer.type={configured!r} is not a "
                f"length-aware per-chunk mode ({Enhancer.LENGTH_AWARE_MODES}); "
                "serving the model family's default full-band cIRM mode")
    return StreamingEngine(enhancer, slots=slots,
                           chunk_samples=int(chunk_seconds * enhancer.sr),
                           pipeline_depth=pipeline_depth, mode=mode)


def query_stats(host: str, port: int, timeout: float = 10.0) -> dict:
    """A running daemon's stats over the wire protocol (header
    {"stats": true} -> one JSON frame -> completion frame)."""
    return _control_request(host, port, {"stats": True}, timeout)


def request_reload(host: str, port: int, checkpoint: str, timeout: float = 3600.0) -> dict:
    """Ask a running daemon to hot-swap to `checkpoint` (a path on the
    daemon's filesystem). Blocks until the new model is built, warmed and
    swapped in, while the daemon keeps serving the old one."""
    return _control_request(host, port, {"reload": checkpoint}, timeout)


def _control_request(host, port, header: dict, timeout: float) -> dict:
    conn = socket.create_connection((host, port), timeout=timeout)
    try:
        _send_frame(conn, json.dumps(header).encode())
        frame = _recv_frame(conn)
        return json.loads(frame.decode()) if frame else {}
    finally:
        conn.close()


def supervise_serve(child_argv, max_restarts: int = 3, log=print, launcher=None) -> int:
    """Relaunch the daemon while it exits non-zero (a lost device, a
    stalled ticker), up to `max_restarts` times; a clean exit (0, an
    operator's shutdown) ends supervision. Streams are lost across a
    restart (clients see EOF without the completion frame), and the
    relaunched daemon warms up again before it accepts clients.

    The supervisor signals only the exact child it spawned: a SIGTERM sent
    to the supervisor is forwarded to that child, whose graceful drain then
    exits 0, and the supervisor with it."""
    import signal

    attempt = 0
    prefix = launcher or [sys.executable, "-m", "fullsubnet_plus_torch.cli.serve"]
    live = {"child": None, "stop": False}

    def _forward(signum, frame):
        # a SIGTERM between a child's exit and the next launch finds no live
        # child: the flag keeps it from being lost to a relaunch
        live["stop"] = True
        c = live["child"]
        if c is not None and c.poll() is None:
            c.send_signal(signal.SIGTERM)  # exact pid only

    prev_term = None
    if threading.current_thread() is threading.main_thread():
        prev_term = signal.signal(signal.SIGTERM, _forward)
    try:
        while True:
            child = subprocess.Popen(list(prefix) + list(child_argv))
            live["child"] = child
            log(f"[serve-supervisor] attempt {attempt}: launched pid {child.pid}")
            rc = child.wait()
            if rc == 0:
                log("[serve-supervisor] clean shutdown")
                return 0
            if live["stop"]:
                log(f"[serve-supervisor] stop requested after exit {rc}: no relaunch")
                return rc
            if attempt >= max_restarts:
                log(f"[serve-supervisor] giving up after {attempt} restart(s) (exit {rc})")
                return rc
            attempt += 1
            log(f"[serve-supervisor] exit {rc}: relaunching ({attempt}/{max_restarts})")
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-C", "--configuration")
    parser.add_argument("-M", "--checkpoint")
    parser.add_argument("--stats", action="store_true",
                        help="query a running daemon at --host/--port, print its "
                             "stats JSON, and exit (no -C/-M needed)")
    parser.add_argument("--reload", metavar="CKPT",
                        help="tell a running daemon at --host/--port to hot-swap to "
                             "this checkpoint (a path on the daemon's filesystem), "
                             "print the ack JSON, and exit (no -C/-M needed)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--slots", type=int, default=8,
                        help="streams per device batch (a fixed shape)")
    parser.add_argument("--dtype", choices=["float32", "bfloat16", "int8"], default=None,
                        help="default: the config's compute_dtype, else int8 (bfloat16 "
                             "with the sub-band LSTM's recurrent products in int8)")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    parser.add_argument("--chunk-seconds", type=float, default=4.0)
    parser.add_argument("--tick", type=float, default=0.1,
                        help="engine tick interval in seconds (a tick with no ready "
                             "chunks costs nothing)")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="batches left in flight: overlaps the copies and the "
                             "compute of successive ticks under load; 0 fetches inline "
                             "(lowest latency)")
    parser.add_argument("--max-tick-failures", type=int, default=5,
                        help="consecutive tick failures before the daemon aborts all "
                             "streams and exits non-zero (pair with --supervise)")
    parser.add_argument("--stall-timeout", type=float, default=300.0,
                        help="seconds without a completed tick before the daemon "
                             "assumes a device call is wedged and exits (0 disables)")
    parser.add_argument("--allow-remote-reload", action="store_true",
                        help="on a non-loopback --host, allow {'reload': path} requests "
                             "for any server-side path (default: only the -M "
                             "checkpoint's directory; loopback binds are unrestricted)")
    parser.add_argument("--watch", type=float, default=None, metavar="SECS",
                        help="poll the -M checkpoint every SECS seconds and hot-swap "
                             "whenever it changes")
    parser.add_argument("--supervise", type=int, default=None, metavar="N",
                        help="run under a supervisor that relaunches the daemon up to N "
                             "times when it exits non-zero (streams are lost across a "
                             "restart)")
    args = parser.parse_args(argv)
    if not (args.stats or args.reload) and (args.configuration is None
                                            or args.checkpoint is None):
        parser.error("-C/--configuration and -M/--checkpoint are required "
                     "(unless --stats/--reload)")
    return args


def build_server(args, log=print) -> StreamServer:
    """The daemon `main` runs, built and warmed but not yet serving: the
    engine for -M with --dtype defaulting to int8 when the config names no
    compute_dtype, one warm-up batch (which builds the CUDA kernels on the
    card, and raises if one does not build), then the bound server."""
    from fullsubnet_plus_torch.utils.config import load_config

    config = load_config(args.configuration)
    if (args.dtype is None
            and "compute_dtype" not in config.get("inferencer", {}).get("args", {})):
        args.dtype = "int8"  # the serving default when nothing is configured

    def make_engine(path):
        return build_engine(config, path, args.slots, args.dtype, args.chunk_seconds,
                            pipeline_depth=args.pipeline_depth, log=log, device=args.device)

    engine = make_engine(args.checkpoint)
    log(f"[serve] warming up on {engine.enhancer.device} ({args.dtype}; the first "
        "run on the card builds the CUDA kernels) ...")
    t0 = time.perf_counter()
    engine.warmup()
    log(f"[serve] warm in {time.perf_counter() - t0:.1f} s")
    server = StreamServer(
        engine, args.host, args.port, args.tick, log=log,
        max_tick_failures=args.max_tick_failures, stall_timeout=args.stall_timeout,
        reload_fn=make_engine, checkpoint_path=args.checkpoint,
        allow_remote_reload=args.allow_remote_reload,
    )
    if args.watch:
        server.watch_checkpoint(args.checkpoint, args.watch)
    return server


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.stats:
        print(json.dumps(query_stats(args.host, args.port)))
        return
    if args.reload:
        resp = request_reload(args.host, args.port, args.reload)
        print(json.dumps(resp))
        if "error" in resp:
            raise SystemExit(1)
        return
    if args.supervise is not None:
        child_argv = list(argv) if argv is not None else sys.argv[1:]
        for i, a in enumerate(child_argv):
            if a == "--supervise":
                del child_argv[i: i + 2]
                break
            if a.startswith("--supervise="):
                del child_argv[i]
                break
        raise SystemExit(supervise_serve(child_argv, args.supervise))
    rc = build_server(args, log=lambda msg: print(msg, flush=True)).serve_forever()
    if rc:
        raise SystemExit(rc)


if __name__ == "__main__":
    main()
