"""TFRecord container I/O without TensorFlow.

Counterpart of ``acoustic_image_generation_tpu/data/tfrecord.py``. Datasets
are GZIP-compressed (or plain) TFRecord files of ``tf.train.SequenceExample``
protos; the container format is

    record := uint64 length | uint32 masked_crc32c(length)
            | bytes data    | uint32 masked_crc32c(data)

with CRC32-C (Castagnoli) and TensorFlow's CRC masking. GZIP files are
whole-stream compressed.

The CRC of a long payload (a second of video is 2.4 MB) is computed in
numpy lanes: the payload is cut into ``_LANES`` equal pieces whose CRC
registers advance together, one byte of each per step, and the pieces are
then chained with the operator that advances a register over a piece's
length of zero bytes (the CRC update is linear over GF(2), so
``R(s, piece) = Z(s) ^ R(0, piece)``). Short payloads take the byte loop.
Both give the table-driven CRC's value exactly.
"""

from __future__ import annotations

import functools
import gzip
import struct
from typing import Iterator

import numpy as np

_POLY = 0x82F63B78  # CRC32-C, reflected
_MASK_DELTA = 0xA282EAD8
_LANES = 4096
_LANE_MIN = 1 << 16  # payloads shorter than this take the byte loop


@functools.cache
def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        table[i] = crc
    return table


def _advance(reg: int, data, table) -> int:
    for b in data:
        reg = table[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _apply(cols: list[int], v: int) -> int:
    """A GF(2) 32x32 matrix (its 32 column images) applied to ``v``."""
    out = 0
    i = 0
    while v:
        if v & 1:
            out ^= cols[i]
        v >>= 1
        i += 1
    return out


@functools.cache
def _zeros_operator(n: int) -> tuple[np.ndarray, ...]:
    """Byte tables of the linear map that advances a CRC register over
    ``n`` zero bytes: ``Z(s) = T0[s & 255] ^ T1[s >> 8 & 255] ^ ...``."""
    table = [int(t) for t in _crc_table()]
    one = [_advance(1 << i, b"\0", table) for i in range(32)]
    power = [1 << i for i in range(32)]  # the identity
    while n:
        if n & 1:
            power = [_apply(one, c) for c in power]
        one = [_apply(one, c) for c in one]
        n >>= 1
    return tuple(
        np.array([_apply(power, b << (8 * k)) for b in range(256)], np.uint32) for k in range(4)
    )


def crc32c(data: bytes) -> int:
    table = _crc_table()
    n = len(data) // _LANES
    if len(data) < _LANE_MIN:
        return _advance(0xFFFFFFFF, data, [int(t) for t in table]) ^ 0xFFFFFFFF
    head = len(data) - n * _LANES
    reg = _advance(0xFFFFFFFF, data[:head], [int(t) for t in table])
    lanes = np.frombuffer(data, np.uint8, offset=head).reshape(_LANES, n).T.copy()
    regs = np.zeros(_LANES, np.uint32)
    for column in lanes:
        regs = table[(regs ^ column) & 0xFF] ^ (regs >> 8)
    z = [[int(v) for v in t] for t in _zeros_operator(n)]
    for r in regs.tolist():
        reg = z[0][reg & 0xFF] ^ z[1][reg >> 8 & 0xFF] ^ z[2][reg >> 16 & 0xFF] ^ z[3][reg >> 24] ^ r
    return reg ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


def write_record(stream, data: bytes) -> None:
    length = struct.pack("<Q", len(data))
    stream.write(length)
    stream.write(struct.pack("<I", masked_crc32c(length)))
    stream.write(data)
    stream.write(struct.pack("<I", masked_crc32c(data)))


def iter_records(stream, *, verify_crc: bool = False) -> Iterator[bytes]:
    while True:
        header = stream.read(12)
        if not header:
            return
        if len(header) < 12:
            raise IOError("truncated TFRecord header")
        (length,) = struct.unpack("<Q", header[:8])
        if verify_crc:
            (crc,) = struct.unpack("<I", header[8:12])
            if masked_crc32c(header[:8]) != crc:
                raise IOError("corrupt TFRecord length crc")
        data = stream.read(length)
        if len(data) < length:
            raise IOError("truncated TFRecord payload")
        footer = stream.read(4)
        if verify_crc:
            (crc,) = struct.unpack("<I", footer)
            if masked_crc32c(data) != crc:
                raise IOError("corrupt TFRecord data crc")
        yield data


def detect_compression(path: str) -> str | None:
    """'GZIP' if the file starts with the gzip magic, else None, so one list
    file may mix gzip shards with uncompressed re-shards."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return "GZIP" if magic == b"\x1f\x8b" else None


def read_records(path: str, *, compression: str | None = "auto",
                 verify_crc: bool = False) -> list[bytes]:
    if compression == "auto":
        compression = detect_compression(path)
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "rb") as f:
        return list(iter_records(f, verify_crc=verify_crc))


def write_records(path: str, records: list[bytes],
                  *, compression: str | None = "GZIP") -> None:
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "wb") as f:
        for rec in records:
            write_record(f, rec)
