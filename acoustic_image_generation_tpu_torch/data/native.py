"""ctypes bindings for the C++ ingest library (``cpp/ingest.cc``).

Counterpart of ``acoustic_image_generation_tpu/data/native.py``: decodes
GZIP (or plain) TFRecord shards of SequenceExamples straight into
preallocated numpy arrays, the native twin of ``tfrecord.py`` + ``proto.py``
+ ``schema.py`` on the loader's hot path.

The source is read from ``cpp/`` at the root of the checkout and built with
``g++ -O3 -shared -fPIC ... -lz`` at first use into
``build/aig_torch_ingest/``, in a file whose name carries a hash of the
source and the flags: an edited source is rebuilt, and the JAX package's
own ``cpp/libaig_ingest.so`` is never touched. ``available()`` says whether
the library built; ``build_error()`` why it did not (no ``g++``, no
``zlib.h``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "cpp" / "ingest.cc"
BUILD_DIR = ROOT / "build" / "aig_torch_ingest"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libaig_ingest-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp), "-lz"]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{done.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if not SOURCE.exists():
                raise FileNotFoundError(f"{SOURCE} is missing")
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.aig_decode_file_v.restype = ctypes.c_int
        lib.aig_decode_file_v.argtypes = [
            ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_int64,  # acoustic
            ctypes.c_void_p, ctypes.c_int64,  # audio
            ctypes.c_void_p, ctypes.c_int64,  # video
            ctypes.POINTER(ctypes.c_int32),  # action
            ctypes.POINTER(ctypes.c_int32),  # location
            ctypes.POINTER(ctypes.c_int32),  # frames
            ctypes.c_int,  # verify_crc
        ]
        lib.aig_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not available (None when it is)."""
    _load()
    return _error


def decode_file_into(
    path: str,
    acoustic: np.ndarray | None,  # (F, 36, 48, C) float32, C-contiguous
    audio: np.ndarray | None,  # (F, 1024) int32
    video: np.ndarray | None,  # (F, 224, 298, 3) uint8
    *,
    verify_crc: bool | None = None,
) -> tuple[int, int, int]:
    """Decode one shard into the given frame slabs. Returns
    ``(action, location, frames_decoded)``; raises ``IOError`` on a decode
    error. ``verify_crc`` checks the TFRecord framing checksums (default:
    the ``AIG_VERIFY_CRC`` environment variable)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_error}")
    act = ctypes.c_int32(-1)
    loc = ctypes.c_int32(-1)
    frames = ctypes.c_int32(0)

    def buf(a):
        if a is None:
            return None, 0
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError("decode_file_into needs C-contiguous arrays")
        return a.ctypes.data_as(ctypes.c_void_p), a.nbytes

    ac_p, ac_n = buf(acoustic)
    au_p, au_n = buf(audio)
    vi_p, vi_n = buf(video)
    if verify_crc is None:
        verify_crc = os.environ.get("AIG_VERIFY_CRC", "0") == "1"
    rc = lib.aig_decode_file_v(
        path.encode(), ac_p, ac_n, au_p, au_n, vi_p, vi_n,
        ctypes.byref(act), ctypes.byref(loc), ctypes.byref(frames),
        1 if verify_crc else 0,
    )
    if rc != 0:
        raise IOError(f"native decode failed for {path}: {lib.aig_last_error().decode()}")
    return int(act.value), int(loc.value), int(frames.value)
