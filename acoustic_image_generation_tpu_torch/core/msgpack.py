"""The part of ``flax.serialization`` that the JAX package's checkpoints
use, in pure Python over numpy and torch (no ``msgpack``, no ``flax``).

``to_bytes(tree)`` gives the bytes ``flax.serialization.to_bytes`` gives for
the same state dict (dicts with string keys over leaves, in the tree's own
key order), and ``msgpack_restore(data)`` reads them back as
``flax.serialization.msgpack_restore`` does.

MessagePack types: maps, arrays, str, bin, nil, bool, ints of every size,
floats (written as float64, read as float32 or float64), ext. Leaves:

- ``np.ndarray`` and ``torch.Tensor`` -> flax's ext type 1 (``ndarray``),
  whose payload is itself MessagePack: ``(shape, dtype name, C-order
  bytes)``; numpy scalars -> ext type 3 (``npscalar``), the same payload of
  a 0-dim array. The buffer goes through as one ``bin`` blob.
- ``bfloat16`` is carried as its bits: a torch ``bfloat16`` tensor is
  written with the dtype name ``bfloat16``, as JAX writes its arrays, and
  such a leaf is read back as a torch ``bfloat16`` tensor (numpy has no
  ``bfloat16`` without ``ml_dtypes``). Every other dtype is read as numpy.
- A leaf over ``MAX_CHUNK_SIZE`` bytes is split into flax's chunked form
  (``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``)
  on write and joined on read, as flax does.

Arrays read back are read-only views on the input bytes.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's limit for one leaf's bytes
EXT_NDARRAY, EXT_NPSCALAR = 1, 3  # flax's ext types (2, a Python complex, is not used)
_CHUNKED = "__msgpack_chunked_array__"
_TORCH_ONLY = {"bfloat16": torch.bfloat16}


# ---------------------------------------------------------------- writing


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} out of MessagePack's range")


def _header(n: int, fix: int, fix_max: int, codes: tuple[int, int, int]) -> bytes:
    if n <= fix_max:
        return struct.pack("B", fix | n)
    if codes[0] and n <= 0xFF:
        return struct.pack("BB", codes[0], n)
    if n <= 0xFFFF:
        return struct.pack(">BH", codes[1], n)
    if n < 2**32:
        return struct.pack(">BI", codes[2], n)
    raise ValueError(f"{n} items or bytes are too many for MessagePack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return struct.pack("BB", 0xC4, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", 0xC5, n)
    if n < 2**32:
        return struct.pack(">BI", 0xC6, n)
    raise ValueError(f"a bin of {n} bytes is too large for MessagePack")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _array_parts(leaf) -> tuple[tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), name, memoryview(raw).cast("B")
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # np.ascontiguousarray would make a 0-dim array 1-dim
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return arr.shape, arr.dtype.name, memoryview(arr.reshape(-1).view(np.uint8)).cast("B")


def _pack_ndarray(leaf, code: int, out: list) -> None:
    shape, name, raw = _array_parts(leaf)
    inner = [_header(3, 0x90, 0x0F, (0, 0xDC, 0xDD)),
             _header(len(shape), 0x90, 0x0F, (0, 0xDC, 0xDD)), *(_int(int(d)) for d in shape),
             _str(name), _bin_header(raw.nbytes)]
    size = sum(len(p) for p in inner) + raw.nbytes
    out.append(_ext_header(code, size))
    out.extend(inner)
    out.append(raw)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.nbytes


def _chunk(leaf) -> dict:
    """flax's ``_chunk``: a leaf over MAX_CHUNK_SIZE bytes as flat chunks."""
    itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(obj, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        out.append(_str(obj))
    elif t in (bytes, bytearray, memoryview):
        raw = memoryview(obj).cast("B")
        out += [_bin_header(raw.nbytes), raw]
    elif t is list:
        out.append(_header(len(obj), 0x90, 0x0F, (0, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif t is dict:
        out.append(_header(len(obj), 0x80, 0x0F, (0, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ndarray(obj, EXT_NDARRAY, out)
    elif isinstance(obj, np.generic):
        _pack_ndarray(np.asarray(obj), EXT_NPSCALAR, out)
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def pack(tree) -> list:
    """The encoded pieces of ``tree``, in order (array buffers as views,
    not copies): ``b"".join(pack(tree))`` is ``to_bytes(tree)``."""
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    out: list = []
    _pack(tree, out)
    return out


def to_bytes(tree) -> bytes:
    """MessagePack of a state dict, as ``flax.serialization.to_bytes``."""
    return b"".join(pack(tree))


# ---------------------------------------------------------------- reading


class _Reader:
    def __init__(self, data) -> None:
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: ("B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unknown MessagePack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a string")
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported MessagePack ext type {code}")
        inner = _Reader(payload)
        if inner.unpack("B") != 0x93:
            raise ValueError("malformed ndarray payload")
        shape, name = inner.read(), inner.read()
        head = inner.unpack("B")
        nbytes = inner.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[head])
        arr = _from_buffer(inner.take(nbytes), name, tuple(shape))
        if code == EXT_NPSCALAR:
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        return arr


def _from_buffer(raw: memoryview, name: str, shape: tuple):
    if name in _TORCH_ONLY:
        bits = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(_TORCH_ONLY[name]).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data):
    """The tree of ``data``, as ``flax.serialization.msgpack_restore``."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the MessagePack object")
    return _unchunk(tree)
