"""TensorBoard event-file writer without TensorFlow.

Counterpart of ``acoustic_image_generation_tpu/utils/tb_events.py``: the
on-disk format of ``tf.summary.FileWriter`` (TFRecord-framed ``Event``
protos in ``events.out.tfevents.*`` files), written with the port's own
proto wire codec (``data/proto.py``) and TFRecord framing
(``data/tfrecord.py``), so stock TensorBoard reads a run directory.

Wire schema (tensorflow/core/util/event.proto and
tensorflow/core/framework/summary.proto):

  Event:          wall_time=1(double) step=2(int64) file_version=3(string)
                  summary=5(message)
  Summary:        value=1(repeated message)
  Summary.Value:  tag=1(string) simple_value=2(float) image=4(message)
                  histo=5(message) audio=6(message)
  Summary.Image:  height=1 width=2 colorspace=3 encoded_image_string=4
  Summary.Audio:  sample_rate=1(float) num_channels=2 length_frames=3
                  encoded_audio_string=4 content_type=5
  HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (all double)
                  bucket_limit=6 bucket=7 (packed repeated double)
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from acoustic_image_generation_tpu_torch.data.proto import (
    _write_len_delimited,
    _write_tag,
    _write_varint,
)
from acoustic_image_generation_tpu_torch.data.tfrecord import write_record

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_FIXED32 = 5


def _double(out: bytearray, field: int, value: float) -> None:
    _write_tag(out, field, _WIRE_FIXED64)
    out += struct.pack("<d", float(value))


def _float(out: bytearray, field: int, value: float) -> None:
    _write_tag(out, field, _WIRE_FIXED32)
    out += struct.pack("<f", float(value))


def _varint_field(out: bytearray, field: int, value: int) -> None:
    if value < 0:
        raise ValueError(f"negative varint field {field}: {value}")
    _write_tag(out, field, _WIRE_VARINT)
    _write_varint(out, int(value))


def _packed_doubles(out: bytearray, field: int, values) -> None:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    _write_len_delimited(out, field, payload)


def encode_event(
    wall_time: float,
    step: int,
    *,
    file_version: str | None = None,
    summary: bytes | None = None,
) -> bytes:
    out = bytearray()
    _double(out, 1, wall_time)
    _varint_field(out, 2, step)
    if file_version is not None:
        _write_len_delimited(out, 3, file_version.encode())
    if summary is not None:
        _write_len_delimited(out, 5, summary)
    return bytes(out)


def encode_summary(values: list[bytes]) -> bytes:
    out = bytearray()
    for v in values:
        _write_len_delimited(out, 1, v)
    return bytes(out)


def scalar_value(tag: str, value: float) -> bytes:
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode())
    _float(out, 2, value)
    return bytes(out)


def _png_geometry(png: bytes) -> tuple[int, int, int]:
    """(height, width, colorspace) from the PNG IHDR. Colorspace uses the
    Summary.Image convention: 1 grayscale, 2 gray+alpha, 3 RGB, 4 RGBA."""
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        raise ValueError("not a PNG")
    width, height = struct.unpack(">II", png[16:24])
    color_type = png[25]
    colorspace = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[color_type]
    return height, width, colorspace


def image_value(tag: str, png: bytes) -> bytes:
    height, width, colorspace = _png_geometry(png)
    img = bytearray()
    _varint_field(img, 1, height)
    _varint_field(img, 2, width)
    _varint_field(img, 3, colorspace)
    _write_len_delimited(img, 4, png)
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode())
    _write_len_delimited(out, 4, bytes(img))
    return bytes(out)


def audio_value(
    tag: str,
    wav: bytes,
    *,
    sample_rate: float,
    num_channels: int = 1,
    length_frames: int = 0,
) -> bytes:
    au = bytearray()
    _float(au, 1, sample_rate)
    _varint_field(au, 2, num_channels)
    _varint_field(au, 3, length_frames)
    _write_len_delimited(au, 4, wav)
    _write_len_delimited(au, 5, b"audio/wav")
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode())
    _write_len_delimited(out, 6, bytes(au))
    return bytes(out)


def histogram_value(tag: str, values, *, bins: int = 30) -> bytes:
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        raise ValueError("empty histogram")
    counts, edges = np.histogram(v, bins=bins)
    h = bytearray()
    _double(h, 1, v.min())
    _double(h, 2, v.max())
    _double(h, 3, v.size)
    _double(h, 4, v.sum())
    _double(h, 5, np.square(v).sum())
    # TF convention: bucket_limit[i] is bucket i's inclusive upper edge
    _packed_doubles(h, 6, edges[1:])
    _packed_doubles(h, 7, counts)
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode())
    _write_len_delimited(out, 5, bytes(h))
    return bytes(out)


class EventFileWriter:
    """Append-only ``events.out.tfevents.*`` writer (one run dir each)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{time.time():.6f}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        write_record(
            self._f, encode_event(time.time(), 0, file_version="brain.Event:2")
        )
        self._f.flush()

    def add_summary(self, values: list[bytes], step: int) -> None:
        """values: encoded Summary.Value messages (scalar_value & co)."""
        write_record(
            self._f,
            encode_event(time.time(), step, summary=encode_summary(values)),
        )
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
