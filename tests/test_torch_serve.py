"""The port's serving engine (fullsubnet_plus_torch.serve) and daemon
(fullsubnet_plus_torch.cli.serve) on the CPU, at a tiny config (33 bins,
hidden 16, sr 1000 so a 4 s chunk is 4000 samples).

The engine is held against the JAX package's StreamingEngine on the same
streams with the same weights (float32 >= 60 dB), and against itself: audio
fed in pieces, or beside other streams, gives what the same stream fed at
once gives (atol 1e-5: float32 round-off of batches composed otherwise).
The daemon tests follow tests/test_serve.py.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from fullsubnet_plus_tpu.enhance import Enhancer as JEnhancer
from fullsubnet_plus_tpu.models import FULLSUBNET_PLUS as J_MODEL
from fullsubnet_plus_tpu.models.fullsubnet_plus import FullSubNetPlusConfig as JConfig
from fullsubnet_plus_tpu.serve import StreamingEngine as JStreamingEngine
from fullsubnet_plus_torch.cli import serve as cli
from fullsubnet_plus_torch.cli.serve import (
    StreamServer,
    _recv_frame,
    _send_frame,
    query_stats,
    request_reload,
)
from fullsubnet_plus_torch.enhance import Enhancer
from fullsubnet_plus_torch.io.checkpoint import save_flat
from fullsubnet_plus_torch.io.convert import state_dict_from_jax
from fullsubnet_plus_torch.models import FULLSUBNET_PLUS
from fullsubnet_plus_torch.models.fullsubnet_plus import FullSubNetPlusConfig
from fullsubnet_plus_torch.serve import StreamingEngine

TINY = dict(num_freqs=33, sb_num_neighbors=4, fb_model_hidden_size=16, sb_model_hidden_size=16)
ACOUSTICS = dict(n_fft=64, hop_length=32, win_length=64, sr=1000)
CHUNK = 4000
SLOTS = 2  # rows per batch: small for CPU time; three streams still need two batches
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_TOML = """
[acoustics]
n_fft = 64
win_length = 64
sr = 1000
hop_length = 32

[inferencer]
type = "mag_complex_full_band_crm_mask"
[inferencer.args]
n_neighbor = 4

[model]
path = "fullsubnet_plus.model.fullsubnet_plus.FullSubNet_Plus"
[model.args]
sb_num_neighbors = 4
fb_num_neighbors = 0
num_freqs = 33
look_ahead = 2
sequence_model = "LSTM"
fb_output_activate_function = "ReLU"
sb_output_activate_function = false
channel_attention_model = "TSSE"
fb_model_hidden_size = 16
sb_model_hidden_size = 16
weight_init = false
norm_type = "offline_laplace_norm"
num_groups_in_drop_band = 2
kersize = [3, 5, 10]
subband_num = 1
"""


def _jax_params(seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  J_MODEL.init(jax.random.PRNGKey(seed), JConfig(**TINY)))


@pytest.fixture(scope="module")
def params():
    return _jax_params(0)


@pytest.fixture(scope="module")
def enhancer(params):
    return _enhancer(params)


def _enhancer(params, **kw):
    return Enhancer(FULLSUBNET_PLUS, FullSubNetPlusConfig(**TINY), state_dict_from_jax(params),
                    device="cpu", **ACOUSTICS, **kw)


def _utt(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _snr(ref, out):
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return 10 * np.log10((ref ** 2).sum() / (((ref - out) ** 2).sum() + 1e-30))


def _at_once(engine_cls, enhancer, y, **kw):
    """One stream fed whole, closed and drained."""
    engine = engine_cls(enhancer, slots=SLOTS, chunk_samples=CHUNK, **kw)
    sid = engine.open()
    engine.feed(sid, y)
    engine.close(sid)
    engine.drain()
    return engine.pull(sid)


_OFFLINE = {}


def _offline(enhancer, y, seed):
    """The port engine's all-at-once result for _utt(len(y), seed), cached."""
    key = (id(enhancer), len(y), seed)
    if key not in _OFFLINE:
        _OFFLINE[key] = _at_once(StreamingEngine, enhancer, y)
    return _OFFLINE[key]


def test_engine_matches_jax_engine(params, enhancer):
    """The same two streams through the JAX engine (HIGHEST matmul
    precision) and the port's, float32, with weights carried across by
    state_dict_from_jax: >= 60 dB."""
    utts = [_utt(9000, 1), _utt(5300, 2)]
    jenhancer = JEnhancer(J_MODEL, JConfig(**TINY), params, **ACOUSTICS)
    with jax.default_matmul_precision("highest"):
        jengine = JStreamingEngine(jenhancer, slots=SLOTS, chunk_samples=CHUNK)
        sids = [jengine.open() for _ in utts]
        for sid, y in zip(sids, utts):
            jengine.feed(sid, y)
            jengine.close(sid)
        jengine.drain()
        refs = [jengine.pull(sid) for sid in sids]
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    sids = [engine.open() for _ in utts]
    for sid, y in zip(sids, utts):
        engine.feed(sid, y)
        engine.close(sid)
    engine.drain()
    for sid, y, ref in zip(sids, utts, refs):
        out = engine.pull(sid)
        assert out.shape == ref.shape == y.shape
        assert _snr(ref, out) >= 60.0, _snr(ref, out)
    assert engine.active == 0 and engine.streams_completed == 2


@pytest.mark.parametrize("depth", [0, 2])
def test_engine_incremental_feed_matches(enhancer, depth):
    """Audio arriving in irregular pieces with a tick after each gives the
    all-at-once waveform; depth 2 exercises the pipelined window."""
    y = _utt(11000, 2)
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK, pipeline_depth=depth)
    sid = engine.open()
    out = []
    cuts = [0, 1700, 4096, 4100, 9000, 11000]
    for a, b in zip(cuts, cuts[1:]):
        engine.feed(sid, y[a:b])
        engine.tick()
        out.append(engine.pull(sid))
    engine.close(sid)
    engine.drain()
    out.append(engine.pull(sid))
    np.testing.assert_allclose(np.concatenate(out), _offline(enhancer, y, 2), atol=1e-5)


@pytest.mark.parametrize("depth", [0, 3])
def test_engine_concurrent_streams(enhancer, depth):
    """Three interleaved streams of different lengths share batches and each
    gives its own single-stream result."""
    utts = {0: _utt(9000, 10), 1: _utt(4500, 11), 2: _utt(12500, 12)}
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK, pipeline_depth=depth)
    sids = {k: engine.open() for k in utts}
    pos = {k: 0 for k in utts}
    outs = {k: [] for k in utts}
    while any(pos[k] < len(utts[k]) for k in utts):
        for k in utts:
            if pos[k] < len(utts[k]):
                engine.feed(sids[k], utts[k][pos[k]: pos[k] + 3000])
                pos[k] += 3000
                if pos[k] >= len(utts[k]):
                    engine.close(sids[k])
        engine.tick()
        for k in utts:
            outs[k].append(engine.pull(sids[k]))
    engine.drain()
    for k, y in utts.items():
        outs[k].append(engine.pull(sids[k]))
        np.testing.assert_allclose(np.concatenate(outs[k]), _offline(enhancer, y, 10 + k),
                                   atol=1e-5, err_msg=f"stream {k}")


def test_engine_buffer_stays_bounded(enhancer):
    """The consumed prefix is trimmed as chunks dispatch: a live stream's
    buffer stays O(chunk), not O(stream length)."""
    y = _utt(20000, 40)
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    sid = engine.open()
    out = []
    for start in range(0, len(y), 2000):
        engine.feed(sid, y[start: start + 2000])
        engine.tick()
        out.append(engine.pull(sid))
        assert len(engine._streams[sid].buffer) <= 3 * engine.chunk
    engine.close(sid)
    engine.drain()
    out.append(engine.pull(sid))
    np.testing.assert_allclose(np.concatenate(out), _offline(enhancer, y, 40), atol=1e-5)


def test_engine_abort_reaps_stream(enhancer):
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    dead = engine.open()
    engine.feed(dead, _utt(6000, 41))
    live = engine.open()
    y = _utt(4500, 11)
    engine.feed(live, y)
    engine.tick()
    engine.abort(dead)
    assert engine.is_done(dead) and engine.streams_aborted == 1
    engine.close(live)
    engine.drain()
    np.testing.assert_allclose(engine.pull(live), _offline(enhancer, y, 11), atol=1e-5)
    assert engine.active == 0


class _PoisonResult:
    """A dispatch whose copy to the host fails."""

    def is_ready(self):
        return True

    def numpy(self):
        raise RuntimeError("device copy failed")


def test_engine_finalize_failure_aborts_stream(enhancer):
    """A failed fetch marks the chunk's streams failed and done (no stuck
    inflight count) and re-raises for the ticker's failure policy."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    engine._dispatch = lambda rows, lens: _PoisonResult()
    sid = engine.open()
    engine.feed(sid, _utt(6000, 50))
    with pytest.raises(RuntimeError, match="device copy failed"):
        engine.tick()
    assert engine.is_failed(sid) and engine.streams_failed == 1
    s = engine._streams[sid]
    assert s.done and s.inflight == 0 and not s.out
    engine.abort(sid)
    assert engine.active == 0


def test_engine_mode_selection(enhancer):
    assert StreamingEngine(enhancer, chunk_samples=CHUNK).mode == \
        "mag_complex_full_band_crm_mask"
    assert Enhancer.LENGTH_AWARE_MODES == ("mag_complex_full_band_crm_mask",)
    with pytest.raises(ValueError, match="length-aware"):
        StreamingEngine(enhancer, chunk_samples=CHUNK, mode="overlapped_chunk")
    with pytest.raises(ValueError, match="even"):
        StreamingEngine(enhancer, chunk_samples=CHUNK + 1)


def test_engine_int8_on_cpu(params):
    """The serving default, int8, through the engine on the CPU (the plain
    int8 LSTM): finite, full length, within 15 dB of float32 (the JAX
    package's int8 bar)."""
    y = _utt(6000, 60)
    out = _at_once(StreamingEngine, _enhancer(params, compute_dtype="int8"), y)
    assert out.shape == y.shape and np.isfinite(out).all()
    assert _snr(_at_once(StreamingEngine, _enhancer(params), y), out) > 15.0


def _client(port, audio, result, idx, frame_size=2048):
    conn = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        _send_frame(conn, json.dumps({"sr": 1000}).encode())
        for start in range(0, len(audio), frame_size):
            _send_frame(conn, audio[start: start + frame_size].tobytes())
        _send_frame(conn, b"")  # end of stream
        chunks = []
        while True:
            frame = _recv_frame(conn)
            if frame is None or frame == b"":
                break
            chunks.append(np.frombuffer(frame, np.float32))
        result[idx] = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    finally:
        conn.close()


def _server(engine, **kw):
    server = StreamServer(engine, port=0, tick_interval=0.02, log=lambda *_: None, **kw)
    server.start()
    return server


def test_tcp_server_end_to_end_and_stats(enhancer):
    """Two concurrent TCP clients get their single-stream waveforms back;
    the stats frame counts the traffic without opening a stream."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = _server(engine)
    try:
        s0 = query_stats("127.0.0.1", server.port)
        assert s0["streams_opened"] == 0 and s0["active_streams"] == 0
        assert s0["slots"] == SLOTS and s0["chunk_samples"] == CHUNK and s0["device"] == "cpu"
        assert s0["mode"] in Enhancer.LENGTH_AWARE_MODES
        utts = [(_utt(9000, 1), 1), (_utt(4500, 11), 11)]
        results = {}
        threads = [threading.Thread(target=_client, args=(server.port, y, results, i))
                   for i, (y, _) in enumerate(utts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(results) == [0, 1]
        for i, (y, seed) in enumerate(utts):
            np.testing.assert_allclose(results[i], _offline(enhancer, y, seed), atol=1e-5)
        s1 = query_stats("127.0.0.1", server.port)
        assert s1["streams_opened"] == s1["streams_completed"] == 2
        assert s1["streams_aborted"] == s1["streams_failed"] == 0
        assert s1["active_streams"] == 0 and s1["chunks_enhanced"] >= 5 + 3
        assert abs(s1["audio_seconds_out"] - 13.5) <= 0.2
        assert s1["ticks"] > 0 and s1["tick_failures"] == 0
        assert s1["busy_tick_ms"]["window"] > 0
        assert s1["busy_tick_ms"]["p99"] >= s1["busy_tick_ms"]["p50"] > 0
        assert set(s1["kernel_launches"]) == {"lstm2_fwd", "lstm2_int8_fwd"}
    finally:
        server.stop()
    assert engine.active == 0


def test_bad_client_does_not_kill_server(enhancer):
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = _server(engine)
    try:
        bad = socket.create_connection(("127.0.0.1", server.port), timeout=10)
        bad.sendall(b"\xff\xff")  # a cut length prefix
        bad.close()
        y, results = _utt(4500, 11), {}
        _client(server.port, y, results, 0)
        np.testing.assert_allclose(results[0], _offline(enhancer, y, 11), atol=1e-5)
    finally:
        server.stop()


def test_server_persistent_failures_exit_nonzero(enhancer):
    """max_tick_failures consecutive failed ticks: every client is cut off
    without the completion frame and serve_forever returns 1."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = StreamServer(engine, port=0, tick_interval=0.01, log=lambda *_: None,
                          max_tick_failures=3)
    rc = {}
    runner = threading.Thread(target=lambda: rc.setdefault("rc", server.serve_forever()),
                              daemon=True)
    runner.start()
    conn = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    try:
        _send_frame(conn, json.dumps({"sr": 1000}).encode())

        def boom(*a, **k):
            raise RuntimeError("device lost")

        engine._base = boom
        _send_frame(conn, _utt(6000, 51).tobytes())
        conn.settimeout(30)
        while True:
            frame = _recv_frame(conn)
            assert frame != b"", "a completion frame after a device failure"
            if frame is None:
                break
        runner.join(timeout=30)
        assert not runner.is_alive() and rc["rc"] == 1 and server.exit_code == 1
    finally:
        conn.close()
        server.stop()


def test_graceful_drain_wedged_ticker_still_exits(enhancer):
    """A shutdown while the ticker is wedged inside a device call (holding
    the serving lock) still ends: the bounded join fails and every client
    is aborted without touching the engine."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    wedge = threading.Event()
    server = StreamServer(engine, port=0, tick_interval=0.01, log=lambda *_: None,
                          stall_timeout=0)
    server.start()
    conn = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    try:
        _send_frame(conn, json.dumps({"sr": 1000}).encode())
        deadline = time.monotonic() + 30
        while engine.active == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.active == 1
        engine.tick = lambda: (wedge.wait(60), 0)[1]
        time.sleep(0.2)  # the ticker enters the wedged tick
        t0 = time.monotonic()
        server._graceful_drain(join_timeout=0.5)
        assert time.monotonic() - t0 < 10
        conn.settimeout(10)
        assert _recv_frame(conn) is None  # aborted: EOF, no completion frame
    finally:
        wedge.set()
        conn.close()
        server.stop()


def test_server_stall_watchdog_exits(enhancer):
    """A ticker wedged inside a device call while it holds the serving
    lock: the watchdog still disconnects the clients and exits with 2."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    wedge = threading.Event()
    engine.tick = lambda: wedge.wait(3)  # a device call that does not return (test-sized)
    server = StreamServer(engine, port=0, tick_interval=0.01, log=lambda *_: None,
                          stall_timeout=1.0)
    try:
        assert server.serve_forever() == 2 and server.exit_code == 2
    finally:
        wedge.set()
        server.stop()


def test_graceful_shutdown_mid_stream(enhancer):
    """A shutdown request mid-stream drains in-flight work: the client gets
    every enhanced frame that was ready, then EOF without the completion
    frame, and serve_forever returns 0."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK, pipeline_depth=2)
    server = StreamServer(engine, port=0, tick_interval=0.02, log=lambda *_: None)
    rc = {}
    runner = threading.Thread(target=lambda: rc.setdefault("rc", server.serve_forever()),
                              daemon=True)
    runner.start()
    conn = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    try:
        _send_frame(conn, json.dumps({"sr": 1000}).encode())
        y = _utt(9000, 1)
        _send_frame(conn, y.tobytes())  # the stream stays open
        deadline = time.monotonic() + 30
        while engine.chunks_enhanced == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert engine.chunks_enhanced > 0
        server.request_shutdown()
        conn.settimeout(30)
        frames, completion = [], False
        while True:
            frame = _recv_frame(conn)
            if frame is None:
                break
            if frame == b"":
                completion = True
                break
            frames.append(np.frombuffer(frame, np.float32))
        assert not completion, "an open stream gets a clean abort, not a completion"
        got = np.concatenate(frames) if frames else np.zeros(0, np.float32)
        # every chunk flushed was complete: a prefix of the closed stream's
        # waveform
        assert len(got) > 0
        np.testing.assert_allclose(got, _offline(enhancer, y, 1)[: len(got)], atol=1e-5)
        runner.join(timeout=30)
        assert not runner.is_alive() and rc["rc"] == 0 and server.exit_code == 0
    finally:
        conn.close()
        server.stop()


def test_checkpoint_hot_swap_and_reload_errors(params, enhancer):
    """{"reload": path} builds and warms a new engine while the old one
    serves, then swaps: a stream before the swap gets the old model's
    waveform, one after it the new model's. A server without reload_fn,
    or whose build raises, answers with an error and keeps serving."""
    e_new = _enhancer(_jax_params(1))
    built = {}

    def reload_fn(path):
        built["path"] = path
        return StreamingEngine(e_new, slots=SLOTS, chunk_samples=CHUNK)

    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = _server(engine, reload_fn=reload_fn, checkpoint_path="old.npz")
    y = _utt(4500, 11)
    try:
        results = {}
        _client(server.port, y, results, 0)
        np.testing.assert_allclose(results[0], _offline(enhancer, y, 11), atol=1e-5)
        ack = request_reload("127.0.0.1", server.port, "new.npz", timeout=60)
        assert ack.get("ok") is True and ack["checkpoint"] == "new.npz"
        assert built["path"] == "new.npz"
        _client(server.port, y, results, 1)
        new = _at_once(StreamingEngine, e_new, y)
        assert _snr(new, results[0]) < 30.0  # the models differ
        np.testing.assert_allclose(results[1], new, atol=1e-5)
        s = query_stats("127.0.0.1", server.port)
        assert s["reloads"] == 1 and s["checkpoint"] == "new.npz"
    finally:
        server.stop()

    server = _server(engine)
    try:
        assert "error" in request_reload("127.0.0.1", server.port, "x.npz", timeout=30)
    finally:
        server.stop()

    def boom(path):
        raise FileNotFoundError(path)

    server = _server(engine, reload_fn=boom)
    try:
        resp = request_reload("127.0.0.1", server.port, "x.npz", timeout=30)
        assert "error" in resp and "x.npz" in resp["error"] and server.reloads == 0
    finally:
        server.stop()


def test_reload_restricted_on_non_loopback_bind(tmp_path, enhancer):
    """On a non-loopback bind, reloads are restricted to the serving
    checkpoint's directory (and refused without one)."""
    inside = tmp_path / "best_model.npz"
    inside.write_bytes(b"x")

    def reload_fn(path):
        return StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)

    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = StreamServer(engine, host="0.0.0.0", port=0, tick_interval=0.02,
                          log=lambda *_: None, reload_fn=reload_fn,
                          checkpoint_path=str(tmp_path / "serving.npz"))
    server.start()
    try:
        resp = request_reload("127.0.0.1", server.port, "/etc/passwd", timeout=30)
        assert "restricted" in resp["error"] and server.reloads == 0
        resp = request_reload("127.0.0.1", server.port, str(inside), timeout=30)
        assert resp.get("ok") is True and server.reloads == 1
    finally:
        server.stop()
    server = StreamServer(engine, host="0.0.0.0", port=0, tick_interval=0.02,
                          log=lambda *_: None, reload_fn=reload_fn, checkpoint_path=None)
    server.start()
    try:
        assert "error" in request_reload("127.0.0.1", server.port, "/etc/passwd", timeout=30)
    finally:
        server.stop()


def test_watch_checkpoint_auto_reload(tmp_path, enhancer):
    """--watch: each change of the checkpoint file triggers one reload; a
    vanished file is tolerated; a failed reload retries without another
    change."""
    ckpt = tmp_path / "latest.npz"
    ckpt.write_bytes(b"v0")
    calls = []

    def flaky_reload(path):
        calls.append(path)
        if len(calls) == 2:
            raise RuntimeError("checkpoint replaced mid-load")
        return StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)

    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = _server(engine, reload_fn=flaky_reload, checkpoint_path=str(ckpt))

    def wait_reloads(n):
        deadline = time.monotonic() + 30
        while server.reloads < n and time.monotonic() < deadline:
            time.sleep(0.05)
        return server.reloads

    try:
        server.watch_checkpoint(str(ckpt), interval=0.05)
        time.sleep(0.3)
        assert calls == []  # unchanged file: no reload
        ckpt.write_bytes(b"v1-longer")
        assert wait_reloads(1) == 1 and len(calls) == 1
        ckpt.unlink()  # vanished: tolerated
        time.sleep(0.3)
        assert len(calls) == 1
        ckpt.write_bytes(b"v2-even-longer")  # one change; its first reload fails
        assert wait_reloads(2) == 2 and len(calls) == 3
    finally:
        server.stop()


def test_stats_and_reload_cli_paths(capsys, enhancer):
    """`--stats` and `--reload` make main() a query client of a running
    daemon; a refused reload exits non-zero."""
    engine = StreamingEngine(enhancer, slots=SLOTS, chunk_samples=CHUNK)
    server = _server(engine, checkpoint_path="a.npz",
                     reload_fn=lambda p: StreamingEngine(enhancer, slots=SLOTS,
                                                         chunk_samples=CHUNK))
    try:
        cli.main(["--stats", "--port", str(server.port)])
        out = json.loads(capsys.readouterr().out.strip())
        assert out["checkpoint"] == "a.npz" and out["reloads"] == 0
        cli.main(["--reload", "b.npz", "--port", str(server.port)])
        out = json.loads(capsys.readouterr().out.strip())
        assert out.get("ok") is True and server.reloads == 1
    finally:
        server.stop()
    server = _server(engine)
    try:
        with pytest.raises(SystemExit):
            cli.main(["--reload", "b.npz", "--port", str(server.port)])
    finally:
        server.stop()


def test_supervise_serve_relaunches(tmp_path):
    """The supervisor relaunches a daemon that exited non-zero and stops at
    a clean exit (a stub daemon: the first launch dies, the second exits 0)."""
    stub = tmp_path / "stub.py"
    stub.write_text("import os, sys\n"
                    "if not os.path.exists(sys.argv[1]):\n"
                    "    open(sys.argv[1], 'w').write('died once')\n"
                    "    sys.exit(1)\n"
                    "sys.exit(0)\n")
    logs = []
    rc = cli.supervise_serve([str(tmp_path / "state")], max_restarts=2, log=logs.append,
                             launcher=[sys.executable, str(stub)])
    assert rc == 0 and any("relaunching" in m for m in logs)


def test_serve_cli_daemon_end_to_end(tmp_path, params):
    """The daemon as a user runs it, in its own process on the CPU: config
    and .npz -> the default dtype, int8, since the config names none ->
    warm-up -> a TCP client streams audio and gets a full-length finite
    waveform and the completion frame; --stats reports no tick failure;
    SIGTERM drains and exits 0."""
    ckpt = tmp_path / "model.npz"
    save_flat(str(ckpt), {"params": params}, {"epoch": 0})
    cfg = tmp_path / "serve.toml"
    cfg.write_text(_SERVE_TOML)
    env = {**os.environ, "PYTHONPATH": REPO}
    child = subprocess.Popen(
        [sys.executable, "-m", "fullsubnet_plus_torch.cli.serve", "-C", str(cfg),
         "-M", str(ckpt), "--port", "0", "--device", "cpu", "--tick", "0.02"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port, deadline = None, time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = child.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"listening on :(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "".join(lines)
        assert any("(int8;" in line for line in lines), "".join(lines)
        y, results = _utt(9000, 60), {}
        _client(port, y, results, 0)
        assert results[0].shape == y.shape and np.isfinite(results[0]).all()
        stats = json.loads(subprocess.run(
            [sys.executable, "-m", "fullsubnet_plus_torch.cli.serve", "--stats", "--port",
             str(port)], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=60).stdout)
        assert stats["streams_completed"] == 1 and stats["tick_failures"] == 0
        assert stats["device"] == "cpu"
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
