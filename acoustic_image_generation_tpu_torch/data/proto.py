"""Minimal protobuf wire-format codec for ``tf.train.SequenceExample`` and
``tf.train.Example``.

Counterpart of ``acoustic_image_generation_tpu/data/proto.py``: exactly the
subset of proto2 wire encoding the dualcam and TUT datasets use:

    SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
    Example      { Features features = 1; }
    Features     { map<string, Feature> feature = 1; }
    FeatureLists { map<string, FeatureList> feature_list = 1; }
    FeatureList  { repeated Feature feature = 1; }
    Feature      { BytesList bytes_list = 1 | FloatList float_list = 2
                 | Int64List int64_list = 3; }

No protobuf runtime dependency; encoding round-trips with TensorFlow's.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator

# ---------------------------------------------------------------- wire level

_WT_VARINT = 0
_WT_LEN = 2


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_tag(out: bytearray, field_no: int, wire_type: int) -> None:
    _write_varint(out, (field_no << 3) | wire_type)


def _write_len_delimited(out: bytearray, field_no: int, payload: bytes) -> None:
    _write_tag(out, field_no, _WT_LEN)
    _write_varint(out, len(payload))
    out.extend(payload)


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_no, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field_no, wire_type = tag >> 3, tag & 7
        if wire_type == _WT_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire_type == _WT_LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire_type == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        elif wire_type == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_no, wire_type, value


def _zigzag_int64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (proto int64 semantics)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------- model

@dataclass
class Feature:
    """One of bytes/float/int64 lists."""

    bytes_list: list[bytes] | None = None
    float_list: list[float] | None = None
    int64_list: list[int] | None = None

    def encode(self) -> bytes:
        out = bytearray()
        if self.bytes_list is not None:
            inner = bytearray()
            for v in self.bytes_list:
                _write_len_delimited(inner, 1, v)
            _write_len_delimited(out, 1, bytes(inner))
        elif self.float_list is not None:
            inner = bytearray()
            packed = struct.pack(f"<{len(self.float_list)}f", *self.float_list)
            _write_len_delimited(inner, 1, packed)
            _write_len_delimited(out, 2, bytes(inner))
        elif self.int64_list is not None:
            inner = bytearray()
            packed = bytearray()
            for v in self.int64_list:
                _write_varint(packed, v & ((1 << 64) - 1))
            _write_len_delimited(inner, 1, bytes(packed))
            _write_len_delimited(out, 3, bytes(inner))
        return bytes(out)

    @staticmethod
    def decode(buf: bytes) -> "Feature":
        feat = Feature()
        for field_no, wire_type, value in _iter_fields(buf):
            if field_no == 1:  # BytesList
                feat.bytes_list = []
                for f2, _, v2 in _iter_fields(value):
                    if f2 == 1:
                        feat.bytes_list.append(bytes(v2))
            elif field_no == 2:  # FloatList
                feat.float_list = []
                for f2, wt2, v2 in _iter_fields(value):
                    if f2 == 1:
                        if wt2 == _WT_LEN:  # packed
                            count = len(v2) // 4
                            feat.float_list.extend(struct.unpack(f"<{count}f", v2))
                        else:  # unpacked 32-bit
                            feat.float_list.append(struct.unpack("<f", v2)[0])
            elif field_no == 3:  # Int64List
                feat.int64_list = []
                for f2, wt2, v2 in _iter_fields(value):
                    if f2 == 1:
                        if wt2 == _WT_LEN:  # packed
                            pos = 0
                            while pos < len(v2):
                                raw, pos = _read_varint(v2, pos)
                                feat.int64_list.append(_zigzag_int64(raw))
                        else:
                            feat.int64_list.append(_zigzag_int64(v2))
        return feat


@dataclass
class SequenceExample:
    context: dict[str, Feature] = field(default_factory=dict)
    feature_lists: dict[str, list[Feature]] = field(default_factory=dict)

    def encode(self) -> bytes:
        out = bytearray()
        ctx = bytearray()
        for key in self.context:
            entry = bytearray()
            _write_len_delimited(entry, 1, key.encode())
            _write_len_delimited(entry, 2, self.context[key].encode())
            _write_len_delimited(ctx, 1, bytes(entry))
        _write_len_delimited(out, 1, bytes(ctx))

        fls = bytearray()
        for key, feats in self.feature_lists.items():
            fl = bytearray()
            for feat in feats:
                _write_len_delimited(fl, 1, feat.encode())
            entry = bytearray()
            _write_len_delimited(entry, 1, key.encode())
            _write_len_delimited(entry, 2, bytes(fl))
            _write_len_delimited(fls, 1, bytes(entry))
        _write_len_delimited(out, 2, bytes(fls))
        return bytes(out)

    @staticmethod
    def decode(buf: bytes) -> "SequenceExample":
        ex = SequenceExample()
        for field_no, _, value in _iter_fields(buf):
            if field_no == 1:  # context: Features
                for f2, _, entry in _iter_fields(value):
                    if f2 != 1:
                        continue
                    key, feat = None, None
                    for f3, _, v3 in _iter_fields(entry):
                        if f3 == 1:
                            key = v3.decode()
                        elif f3 == 2:
                            feat = Feature.decode(v3)
                    if key is not None and feat is not None:
                        ex.context[key] = feat
            elif field_no == 2:  # feature_lists
                for f2, _, entry in _iter_fields(value):
                    if f2 != 1:
                        continue
                    key, feats = None, []
                    for f3, _, v3 in _iter_fields(entry):
                        if f3 == 1:
                            key = v3.decode()
                        elif f3 == 2:
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:
                                    feats.append(Feature.decode(v4))
                    if key is not None:
                        ex.feature_lists[key] = feats
        return ex


# convenience constructors

def int64_feature(value: int) -> Feature:
    return Feature(int64_list=[value])


def bytes_feature(value: bytes) -> Feature:
    return Feature(bytes_list=[value])


def int64_list_feature(values: list[int]) -> Feature:
    return Feature(int64_list=list(values))


@dataclass
class Example:
    """Plain ``tf.train.Example``: a bare ``Features`` map, what the TUT
    shards hold (``data/tut.py``)."""

    features: dict[str, Feature] = field(default_factory=dict)

    def encode(self) -> bytes:
        out = bytearray()
        feats = bytearray()
        for key in self.features:
            entry = bytearray()
            _write_len_delimited(entry, 1, key.encode())
            _write_len_delimited(entry, 2, self.features[key].encode())
            _write_len_delimited(feats, 1, bytes(entry))
        _write_len_delimited(out, 1, bytes(feats))
        return bytes(out)

    @staticmethod
    def decode(buf: bytes) -> "Example":
        ex = Example()
        for field_no, _, value in _iter_fields(buf):
            if field_no != 1:
                continue
            for f2, _, entry in _iter_fields(value):
                if f2 != 1:
                    continue
                key, feat = None, None
                for f3, _, v3 in _iter_fields(entry):
                    if f3 == 1:
                        key = v3.decode()
                    elif f3 == 2:
                        feat = Feature.decode(v3)
                if key is not None and feat is not None:
                    ex.features[key] = feat
        return ex
