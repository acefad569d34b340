"""Dependency-free TensorBoard event-file writer.

Counterpart of fullsubnet_plus_tpu/utils/tb_events.py (a copy; the port
does not import the JAX package). The trainer logs train and validation
losses, metric means, audio triptychs and spectrogram figures (reference
base_trainer.py:236-302) without tensorboardX: an event file is a sequence
of TFRecords (length + masked-CRC32C framing) whose payloads are
hand-encoded protobuf `Event` messages, so no protobuf runtime, no
background flush thread, and audio as embedded PCM16 WAV without soundfile.

Wire format references (public, stable):
  * TFRecord framing: u64le length, masked crc32c(length), payload,
    masked crc32c(payload); mask(c) = ((c>>15 | c<<17) + 0xa282ead8).
  * event.proto:   Event{1: double wall_time, 2: int64 step,
                         3: string file_version, 5: Summary summary}
  * summary.proto: Summary{1: repeated Value};
                   Value{1: string tag, 2: float simple_value,
                         4: Image image, 6: Audio audio}
                   Image{1: int32 height, 2: int32 width,
                         3: int32 colorspace, 4: bytes encoded_image_string}
                   Audio{1: float sample_rate, 2: int64 num_channels,
                         3: int64 length_frames, 4: bytes encoded_audio_string,
                         5: string content_type}
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected poly 0x82F63B78) — table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding helpers
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _f_double(field: int, x: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", x)


def _f_float(field: int, x: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", x)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _event(payload_fields: bytes, step: int | None = None,
           wall_time: float | None = None) -> bytes:
    out = _f_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _f_varint(2, step)
    return out + payload_fields


def _wav_bytes(snd: np.ndarray, sample_rate: int) -> bytes:
    """Minimal PCM16 mono WAV container."""
    pcm = np.clip(np.round(np.asarray(snd, np.float64) * 32767.0),
                  -32768, 32767).astype("<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
        sample_rate, sample_rate * 2, 2, 16, b"data", len(pcm),
    )
    return hdr + pcm


def _png_size(png: bytes) -> tuple:
    """(height, width) from the IHDR chunk."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        return 0, 0
    w, h = struct.unpack(">II", png[16:24])
    return h, w


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class EventWriter:
    """Drop-in for the tensorboardX SummaryWriter subset the trainer uses
    (add_scalar / add_audio / add_figure): synchronous small appends, no
    background thread, no protobuf import."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "ab")
        # TB requires a leading file_version event.
        self._write(_event(_f_str(3, "brain.Event:2")))

    def _write(self, event: bytes) -> None:
        length = struct.pack("<Q", len(event))
        self._f.write(length)
        self._f.write(struct.pack("<I", _masked_crc(length)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))
        self._f.flush()

    def _summary(self, *values: bytes) -> bytes:
        return _f_bytes(5, b"".join(_f_bytes(1, v) for v in values))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(
            self._summary(_f_str(1, tag) + _f_float(2, float(value))),
            step=step,
        ))

    def add_audio(self, tag: str, snd, step: int, sample_rate: int = 16000) -> None:
        snd = np.asarray(snd).reshape(-1)
        audio = (
            _f_float(1, float(sample_rate))
            + _f_varint(2, 1)
            + _f_varint(3, len(snd))
            + _f_bytes(4, _wav_bytes(snd, sample_rate))
            + _f_str(5, "audio/wav")
        )
        self._write(_event(
            self._summary(_f_str(1, tag) + _f_bytes(6, audio)), step=step,
        ))

    def add_figure(self, tag: str, figure, step: int) -> None:
        buf = io.BytesIO()
        figure.savefig(buf, format="png")
        png = buf.getvalue()
        h, w = _png_size(png)
        image = (
            _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, 4)  # RGBA
            + _f_bytes(4, png)
        )
        self._write(_event(
            self._summary(_f_str(1, tag) + _f_bytes(4, image)), step=step,
        ))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

