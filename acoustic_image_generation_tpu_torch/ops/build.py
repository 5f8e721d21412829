"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, at first use, into ``build/aig_torch_kernels/`` at the
root of the checkout. The file name carries a hash of the sources and the
flags, so an edited source is rebuilt and a stale library is never loaded.
The libraries are loaded with ``ctypes``; pointers and the stream pass as
``c_void_p``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aig_torch_kernels"
KERNELS = ("mfcc", "conv_chain", "matmul_stats")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes at once. Returns ``{name: (seconds, compiler log)}``
    for the libraries it built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            started[name] = (proc, tmp, out, time.perf_counter())
        report = {}
        for name, (proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            report[name] = (time.perf_counter() - t0, log)
        return report
    finally:
        for proc, tmp, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
