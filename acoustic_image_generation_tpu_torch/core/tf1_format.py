"""TF1 checkpoint files, read and written in numpy.

What TensorFlow's checkpoint reader and ``tf.compat.v1.train.Saver`` do for
the two formats the reference's checkpoints come in, so that the port reads
and writes them on a machine without the ``tensorflow`` package:

- **V2** (the tensor bundle): ``PREFIX.index`` is a LevelDB table whose
  ``""`` key holds a ``BundleHeaderProto`` (shard count, endianness) and
  whose every other key is a tensor name holding a ``BundleEntryProto``
  (dtype, shape, shard, offset, size, masked crc32c of the bytes). The
  tensors are raw little-endian bytes in ``PREFIX.data-0000K-of-0000N``.
- **V1** (one table of tensor slices at the path itself): its ``""`` key
  holds the ``SavedTensorSliceMeta`` (each tensor's name, shape, dtype and
  slices), every other key one ``SavedSlice`` whose ``TensorProto`` carries
  the values (``tensor_content`` or the repeated ``float_val``,
  ``int64_val``, ...).

The table (``table/format.cc``, ``table_builder.cc``): blocks of
prefix-compressed entries with a restart point every 16 entries (every
entry in the index block), each block followed by a type byte and the
masked crc32c of the block and that byte; an index block of one key and
block handle per data block (TF writes a short separator key there, the
port the block's last key: a reader takes any key from the block's last to
before the next block's first); a 48-byte footer with the index's
handle and the magic number. Every block's crc32c and every V2 tensor's is
verified; a compressed block (type byte other than 0) or a dtype other than
f32, f64, f16, bf16, i32, i64 and bool raises by name. A bf16 tensor is
returned as its uint16 bit pattern (``load_tf1_checkpoint`` widens it).

``write_checkpoint`` writes the V2 files that ``Saver(write_meta_graph=
False)`` writes, as TF's reader reads them: the ``.index``, one data shard
and the directory's ``checkpoint`` state file, no ``.meta``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from acoustic_image_generation_tpu_torch.data.proto import (
    _iter_fields,
    _read_varint,
    _write_len_delimited,
    _write_tag,
    _write_varint,
    _zigzag_int64,
)
from acoustic_image_generation_tpu_torch.data.tfrecord import masked_crc32c

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48  # two block handles padded to 40 bytes, then the magic
BLOCK_BYTES = 262144  # table::Options::block_size
RESTART_INTERVAL = 16
COMPRESSION = {1: "snappy"}  # table::CompressionType

# tensorflow/core/framework/types.proto
_DT_FLOAT, _DT_DOUBLE, _DT_INT32, _DT_INT64, _DT_BOOL, _DT_BFLOAT16, _DT_HALF = 1, 2, 3, 9, 10, 14, 19
DTYPES = {
    _DT_FLOAT: np.dtype("<f4"),
    _DT_DOUBLE: np.dtype("<f8"),
    _DT_INT32: np.dtype("<i4"),
    _DT_INT64: np.dtype("<i8"),
    _DT_BOOL: np.dtype(np.bool_),
    _DT_BFLOAT16: np.dtype("<u2"),  # the bit pattern
    _DT_HALF: np.dtype("<f2"),
}
_CODES = {np.dtype(np.float32): _DT_FLOAT, np.dtype(np.float64): _DT_DOUBLE, np.dtype(np.int32): _DT_INT32,
          np.dtype(np.int64): _DT_INT64, np.dtype(np.bool_): _DT_BOOL, np.dtype(np.float16): _DT_HALF}
_DTYPE_NAMES = {4: "uint8", 5: "int16", 6: "int8", 7: "string", 8: "complex64", 17: "uint16", 18: "complex128",
                22: "uint32", 23: "uint64"}
TENSOR_BUNDLE_VERSION = 1


def _dtype(code: int, name: str) -> np.dtype:
    if code not in DTYPES:
        raise ValueError(f"tensor {name!r}: dtype {_DTYPE_NAMES.get(code, code)} is not one of f32, f64, f16, "
                         "bf16, i32, i64, bool")
    return DTYPES[code]


def _fields(buf: bytes) -> dict:
    """Field number -> list of values of one message."""
    out: dict = {}
    for no, _, value in _iter_fields(bytes(buf)):
        out.setdefault(no, []).append(value)
    return out


# ---------------------------------------------------------------- the table


def _block(buf: bytes, offset: int, size: int, path: str) -> bytes:
    """One block's contents, its trailer checked."""
    if offset + size + 5 > len(buf):
        raise IOError(f"{path}: block at {offset} runs past the end of the file")
    kind = buf[offset + size]
    (crc,) = struct.unpack_from("<I", buf, offset + size + 1)
    if masked_crc32c(buf[offset:offset + size + 1]) != crc:
        raise IOError(f"{path}: block checksum mismatch at offset {offset}")
    if kind != 0:
        raise IOError(f"{path}: {COMPRESSION.get(kind, 'unknown')}-compressed block (type byte {kind}) at offset "
                      f"{offset}; only uncompressed tables are read")
    return buf[offset:offset + size]


def _entries(block: bytes):
    """(key, value) of each entry of a block, keys restored from their
    shared prefixes."""
    (restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * restarts
    pos, key = 0, b""
    while pos < end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        size, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + unshared]
        pos += unshared
        yield key, block[pos:pos + size]
        pos += size


def _handle(buf: bytes, pos: int = 0) -> tuple[int, int, int]:
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return offset, size, pos


def read_table(path: str) -> list[tuple[bytes, bytes]]:
    """Every (key, value) of a table file, in key order."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < FOOTER_BYTES or struct.unpack_from("<Q", buf, len(buf) - 8)[0] != TABLE_MAGIC:
        raise IOError(f"{path}: not a TF checkpoint table (no table magic number)")
    footer = buf[-FOOTER_BYTES:]
    _, _, pos = _handle(footer)  # the metaindex: empty in a checkpoint
    index_offset, index_size, _ = _handle(footer, pos)
    out = []
    for _, value in _entries(_block(buf, index_offset, index_size, path)):
        offset, size, _ = _handle(value)
        out.extend(_entries(_block(buf, offset, size, path)))
    return out


class _BlockBuilder:
    def __init__(self, interval: int):
        self.interval, self.buf, self.restarts, self.count, self.last = interval, bytearray(), [0], 0, b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.count < self.interval:
            n = min(len(key), len(self.last))
            while shared < n and key[shared] == self.last[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.count = 0
        for v in (shared, len(key) - shared, len(value)):
            _write_varint(self.buf, v)
        self.buf += key[shared:]
        self.buf += value
        self.last, self.count = key, self.count + 1

    @property
    def empty(self) -> bool:
        return not self.buf

    def size(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        return bytes(self.buf) + struct.pack(f"<{len(self.restarts) + 1}I", *self.restarts, len(self.restarts))


def _encode_handle(offset: int, size: int) -> bytes:
    out = bytearray()
    _write_varint(out, offset)
    _write_varint(out, size)
    return bytes(out)


def write_table(path: str, entries: list[tuple[bytes, bytes]]) -> None:
    """A table of ``entries`` (sorted by key, bytewise), uncompressed, as
    ``TableBuilder`` lays it out."""
    with open(path, "wb") as f:
        offset = 0

        def write_block(contents: bytes) -> tuple[int, int]:
            nonlocal offset
            trailer = b"\0" + struct.pack("<I", masked_crc32c(contents + b"\0"))
            f.write(contents + trailer)
            at, offset = offset, offset + len(contents) + len(trailer)
            return at, len(contents)

        data, index = _BlockBuilder(RESTART_INTERVAL), _BlockBuilder(1)
        pending, last = None, b""
        for key, value in entries:
            if key < last:
                raise ValueError(f"table keys out of order: {key!r} after {last!r}")
            if pending is not None:
                index.add(last, _encode_handle(*pending))
                pending = None
            data.add(key, value)
            last = key
            if data.size() >= BLOCK_BYTES:
                pending, data = write_block(data.finish()), _BlockBuilder(RESTART_INTERVAL)
        if not data.empty:
            pending = write_block(data.finish())
        meta = write_block(_BlockBuilder(RESTART_INTERVAL).finish())
        if pending is not None:
            index.add(last, _encode_handle(*pending))
        footer = _encode_handle(*meta) + _encode_handle(*write_block(index.finish()))
        f.write(footer.ljust(FOOTER_BYTES - 8, b"\0") + struct.pack("<Q", TABLE_MAGIC))


# ---------------------------------------------------------------- V2: the tensor bundle


def _shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 { int64 size = 1 }."""
    dims = []
    for dim in _fields(buf).get(2, []):
        dims.append(_zigzag_int64(_fields(dim).get(1, [0])[0]))
    return tuple(dims)


def _read_v2(prefix: str) -> dict[str, np.ndarray]:
    entries = read_table(prefix + ".index")
    if not entries or entries[0][0] != b"":
        raise IOError(f"{prefix}.index: no bundle header")
    header = _fields(entries[0][1])
    shards = header.get(1, [1])[0]
    if header.get(2, [0])[0] != 0:
        raise IOError(f"{prefix}: a big-endian tensor bundle")
    files: dict[int, object] = {}
    out = {}
    try:
        for key, value in entries[1:]:
            name = key.decode()
            e = _fields(value)
            if 7 in e:
                raise ValueError(f"tensor {name!r} is saved in slices (a partitioned variable); not read")
            dtype = _dtype(e.get(1, [0])[0], name)
            shape = _shape(e[2][0]) if 2 in e else ()
            shard, offset, size = (e.get(k, [0])[0] for k in (3, 4, 5))
            if shard not in files:
                files[shard] = open(f"{prefix}.data-{shard:05d}-of-{shards:05d}", "rb")
            f = files[shard]
            f.seek(offset)
            raw = f.read(size)
            if len(raw) != size:
                raise IOError(f"{prefix}: tensor {name!r} runs past the end of shard {shard}")
            if masked_crc32c(raw) != struct.unpack("<I", e[6][0])[0]:
                raise IOError(f"{prefix}: crc32c mismatch in tensor {name!r}")
            out[name] = np.frombuffer(raw, dtype).reshape(shape).copy()
    finally:
        for f in files.values():
            f.close()
    return out


def _bundle_entry(dtype: int, shape: tuple, offset: int, size: int, crc: int) -> bytes:
    """BundleEntryProto in field order; proto3 leaves zero scalars out."""
    out = bytearray()
    _write_tag(out, 1, 0)
    _write_varint(out, dtype)
    dims = bytearray()
    for d in shape:
        dim = bytearray()
        if d:
            _write_tag(dim, 1, 0)
            _write_varint(dim, d)
        _write_len_delimited(dims, 2, bytes(dim))
    _write_len_delimited(out, 2, bytes(dims))
    for no, v in ((4, offset), (5, size)):
        if v:
            _write_tag(out, no, 0)
            _write_varint(out, v)
    _write_tag(out, 6, 5)
    out += struct.pack("<I", crc)
    return bytes(out)


def _bundle_header(shards: int) -> bytes:
    """BundleHeaderProto: num_shards, little-endian (0, left out) and the
    bundle version {producer: 1}."""
    out = bytearray()
    _write_tag(out, 1, 0)
    _write_varint(out, shards)
    version = bytearray()
    _write_tag(version, 1, 0)
    _write_varint(version, TENSOR_BUNDLE_VERSION)
    _write_len_delimited(out, 3, bytes(version))
    return bytes(out)


def _c_escape(s: str) -> str:
    """The text format's string escaping."""
    out = []
    for b in s.encode():
        c = chr(b)
        out.append({"\n": "\\n", "\r": "\\r", "\t": "\\t", '"': '\\"', "'": "\\'", "\\": "\\\\"}.get(
            c, c if 0x20 <= b < 0x7F else f"\\{b:03o}"))
    return "".join(out)


def write_checkpoint(path: str, tensors: dict[str, np.ndarray]) -> str:
    """Write ``tensors`` as the V2 checkpoint ``path`` (``path.index``,
    ``path.data-00000-of-00001``) and the ``checkpoint`` state file beside
    it naming ``path`` (relative to its directory unless ``path`` is
    absolute, as TF writes it). Returns ``path``."""
    entries = [(b"", _bundle_header(1))]
    offset = 0
    with open(path + ".data-00000-of-00001", "wb") as f:
        for name in sorted(tensors, key=str.encode):
            arr = np.asarray(tensors[name])
            if arr.dtype.newbyteorder("=") not in _CODES:
                raise ValueError(f"tensor {name!r}: dtype {arr.dtype} is not one of f32, f64, f16, i32, i64, bool")
            raw = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes()
            f.write(raw)
            entries.append((name.encode(), _bundle_entry(_CODES[arr.dtype.newbyteorder("=")], arr.shape, offset,
                                                         len(raw), masked_crc32c(raw))))
            offset += len(raw)
    write_table(path + ".index", entries)
    directory = os.path.dirname(path) or "."
    name = path if os.path.isabs(path) else os.path.relpath(path, directory)
    with open(os.path.join(directory, "checkpoint"), "w") as f:
        f.write(f'model_checkpoint_path: "{_c_escape(name)}"\nall_model_checkpoint_paths: "{_c_escape(name)}"\n')
    return path


# ---------------------------------------------------------------- V1: tensor slices

_VALUE_FIELD = {_DT_FLOAT: 5, _DT_DOUBLE: 6, _DT_INT32: 7, _DT_INT64: 10, _DT_BOOL: 11, _DT_BFLOAT16: 13,
                _DT_HALF: 13}  # TensorProto's repeated field of each dtype (half_val holds f16 and bf16 bits)
_FIXED = {5: "<f4", 6: "<f8"}  # float_val, double_val: fixed width, packed or not


def _tensor_values(proto: bytes, code: int, count: int, name: str) -> np.ndarray:
    """A TensorProto's ``count`` values: its ``tensor_content``, or its
    repeated field."""
    dtype = DTYPES[code]
    t = _fields(proto)
    if 4 in t:
        out = np.frombuffer(t[4][0], dtype)
    else:
        field = _VALUE_FIELD[code]
        values = t.get(field, [])
        if field in _FIXED:
            out = np.frombuffer(b"".join(values), _FIXED[field])
        else:
            ints = []
            for v in values:
                if isinstance(v, int):  # one unpacked varint
                    ints.append(v)
                    continue
                pos = 0
                while pos < len(v):  # packed varints
                    x, pos = _read_varint(v, pos)
                    ints.append(x)
            ints = np.array([_zigzag_int64(x) for x in ints], np.int64)
            out = ints.astype(np.uint16).view(dtype) if field == 13 else ints.astype(dtype)
    if out.size != count:
        raise IOError(f"tensor {name!r}: {out.size} values for a slice of {count}")
    return out.astype(dtype, copy=True)


def _slice(buf: bytes, shape: tuple) -> tuple:
    """TensorSliceProto -> numpy index: repeated Extent extent = 1 {start 1,
    length 2}, one a dimension; an extent without a length spans it."""
    index = []
    for n, ext in zip(shape, _fields(buf).get(1, []), strict=True):
        e = _fields(ext)
        start = _zigzag_int64(e.get(1, [0])[0])
        index.append(slice(start, start + _zigzag_int64(e[2][0])) if 2 in e else slice(0, n))
    return tuple(index)


def _read_v1(path: str) -> dict[str, np.ndarray]:
    entries = read_table(path)
    if not entries or entries[0][0] != b"":
        raise IOError(f"{path}: no tensor-slice metadata")
    meta = {}
    for t in _fields(_fields(entries[0][1])[1][0]).get(1, []):
        m = _fields(t)
        name = m[1][0].decode()
        code = m.get(3, [0])[0]
        _dtype(code, name)
        meta[name] = (_shape(m[2][0]) if 2 in m else (), code)
    out = {name: np.zeros(shape, DTYPES[code]) for name, (shape, code) in meta.items()}
    for _, value in entries[1:]:
        saved = _fields(_fields(value)[2][0])
        name = saved[1][0].decode()
        shape, code = meta[name]
        index = _slice(saved[2][0], shape) if 2 in saved else tuple(slice(0, n) for n in shape)
        part = tuple(s.stop - s.start for s in index)
        out[name][index] = _tensor_values(saved[3][0], code, int(np.prod(part)), name).reshape(part)
    return out


def read_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Every tensor of the TF1 checkpoint ``path`` by name: V2 when
    ``path.index`` exists, else the V1 file ``path``."""
    if os.path.exists(path + ".index"):
        return _read_v2(path)
    if os.path.isfile(path):
        return _read_v1(path)
    raise FileNotFoundError(f"no TF1 checkpoint at {path} (neither {path}.index nor the file)")
