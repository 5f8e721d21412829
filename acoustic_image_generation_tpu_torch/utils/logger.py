"""Run logger: scalars, images, audio and histograms without TensorFlow or
matplotlib.

Counterpart of ``acoustic_image_generation_tpu/utils/logger.py``: scalars
append to ``metrics.jsonl``, images go to PNG files and audio to WAV files
under ``media/``, histograms to summary statistics in the jsonl record, and
every record is mirrored into a TensorBoard event file (``tb_events.py``).

PNGs are written here with ``zlib`` (8-bit RGBA, as ``matplotlib``'s
``imsave`` writes them). A 2-D image is scaled to its own [min, max] and
mapped through a colour table: ``"jet"`` (``matplotlib``'s 256-entry table,
built from its segment data the way ``matplotlib`` builds it) or ``None``
(gray). An (H, W, 3) image is written as it is: floats clipped to [0, 1],
or uint8.
"""

from __future__ import annotations

import json
import os
import struct
import time
import wave
import zlib

import numpy as np

from acoustic_image_generation_tpu_torch.utils import tb_events

_JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
_LUT_SIZE = 256


def _segment_lut(data, n: int = _LUT_SIZE) -> np.ndarray:
    """One channel of a table from (x, y0, y1) segments, as
    ``matplotlib.colors._create_lookup_table`` builds it."""
    adata = np.asarray(data, np.float64)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colour_table(cmap: str | None) -> np.ndarray:
    """(256, 4) uint8 RGBA table of ``cmap`` ("jet" or None for gray)."""
    if cmap == "jet":
        rgb = np.stack([_segment_lut(_JET[c]) for c in ("red", "green", "blue")], axis=1)
    elif cmap is None:
        rgb = np.repeat(np.linspace(0, 1, _LUT_SIZE)[:, None], 3, axis=1)
    else:
        raise ValueError(f"colour map {cmap!r}: the port writes 'jet' or gray (None)")
    return (np.concatenate([rgb, np.ones((_LUT_SIZE, 1))], axis=1) * 255).astype(np.uint8)


def to_rgba(image, cmap: str | None = None) -> np.ndarray:
    """(H, W) -> (H, W, 4) uint8 through the colour table, the values scaled
    to their [min, max] in their own float precision; (H, W, 3) floats
    clipped to [0, 1] or uint8 -> RGBA with alpha 255."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        x = arr.astype(np.float32) if arr.dtype.kind != "f" else arr.copy()
        lo, hi = x.min(), x.max()
        x -= lo
        x = x / (hi - lo) if hi > lo else np.zeros_like(x)
        x *= _LUT_SIZE
        x[x == _LUT_SIZE] = _LUT_SIZE - 1
        return colour_table(cmap)[np.clip(x, 0, _LUT_SIZE - 1).astype(int)]
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"image of shape {arr.shape}: need (H, W), (H, W, 1) or (H, W, 3)")
    rgb = arr if arr.dtype == np.uint8 else (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(rgba: np.ndarray) -> bytes:
    """8-bit RGBA PNG of an (H, W, 4) uint8 array (no row filters)."""
    h, w, _ = rgba.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


class Logger:
    def __init__(self, log_dir: str, *, tb: bool = True):
        self.log_dir = log_dir
        self.media_dir = os.path.join(log_dir, "media")
        os.makedirs(self.media_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = tb_events.EventFileWriter(log_dir) if tb else None

    def _write(self, record: dict) -> None:
        record.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _tb_add(self, values: list[bytes], step: int) -> None:
        if self._tb is not None:
            self._tb.add_summary(values, step)

    def log_scalar(self, tag: str, value, step: int) -> None:
        self._write({"step": step, tag: float(value)})
        self._tb_add([tb_events.scalar_value(tag, float(value))], step)

    def log_scalars(self, values: dict, step: int) -> None:
        self._write({"step": step, **{k: float(v) for k, v in values.items()}})
        self._tb_add([tb_events.scalar_value(k, float(v)) for k, v in values.items()], step)

    def log_histogram(self, tag: str, values, step: int) -> None:
        v = np.asarray(values).ravel()
        self._write({
            "step": step,
            f"{tag}/mean": float(v.mean()),
            f"{tag}/std": float(v.std()),
            f"{tag}/min": float(v.min()),
            f"{tag}/max": float(v.max()),
        })
        self._tb_add([tb_events.histogram_value(tag, v)], step)

    def log_image(self, tag: str, image, step: int, *, cmap: str | None = None) -> str:
        """image: (H, W), (H, W, 1) or (H, W, 3), floats in [0,1] or uint8."""
        path = os.path.join(self.media_dir, f"{tag.replace('/', '_')}_{step}.png")
        png = encode_png(to_rgba(image, cmap))
        with open(path, "wb") as f:
            f.write(png)
        self._write({"step": step, f"{tag}/image": os.path.relpath(path, self.log_dir)})
        self._tb_add([tb_events.image_value(tag, png)], step)
        return path

    def log_sound(self, tag: str, samples, step: int, sample_rate: int = 12288) -> str:
        path = os.path.join(self.media_dir, f"{tag.replace('/', '_')}_{step}.wav")
        data = np.asarray(samples)
        if data.dtype != np.int16:
            peak = max(np.abs(data).max(), 1e-9)
            data = (data / peak * 32767).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(data.tobytes())
        self._write({"step": step, f"{tag}/audio": os.path.relpath(path, self.log_dir)})
        with open(path, "rb") as f:
            self._tb_add([tb_events.audio_value(tag, f.read(), sample_rate=sample_rate,
                                                length_frames=len(data))], step)
        return path

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
