"""The zero-phase Butterworth low-pass kernel (``csrc/sosfilt.cu``) and its
wrapper.

No Pallas kernel corresponds to it: the JAX package runs the filter as a
``lax.scan`` (``acoustic_image_generation_tpu/dsp/iir.py::filtfilt_jax``).
The plain version is ``dsp.iir.filtfilt``, a Python loop over the time
steps that would launch some 65 thousand small kernels a batch on the card.
The kernel runs one thread per row on the float32 sections and ``zi`` of
``kernel_tables`` (uploaded once per device), rounding every operation as
the plain version does, so the two are bit-equal. A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.dsp import iir
from acoustic_image_generation_tpu_torch.ops import build

filtfilt_plain = iir.filtfilt
SECTIONS = iir.DEFAULT_ORDER // 2  # the kernel's compile-time cascade length


@functools.cache
def kernel_tables() -> dict[str, np.ndarray]:
    """The tables ``csrc/sosfilt.cu`` reads, in the order of its arguments:
    the (5, 6) sections and the (5, 2) ``zi``, float32."""
    sos, zi = iir.tables_f32()
    return dict(sos=np.ascontiguousarray(sos), zi=np.ascontiguousarray(zi))


@functools.cache
def _entry():
    fn = build.library("sosfilt").aig_filtfilt
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, ctypes.c_int, ctypes.c_int, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def filtfilt(x: torch.Tensor) -> torch.Tensor:
    """(..., T) float32 -> (..., T) float32: the order-10, 125 Hz
    Butterworth low-pass at 12288 Hz, forward and backward (``dsp.iir``).

    On the CPU: the plain version. On CUDA: one launch of the kernel,
    counted in ``filtfilt.launches``. Raises ``ValueError`` for another
    device, another dtype, a non-contiguous input, or rows of at most
    ``padlen + 1`` samples."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"filtfilt runs on cpu or cuda, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"filtfilt takes float32 samples, got {x.dtype}")
    pad = iir.padlen()
    if x.dim() < 1 or x.shape[-1] <= pad + 1:
        raise ValueError(f"filtfilt takes (..., T) samples with T > {pad + 1}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("filtfilt takes contiguous samples")
    if x.device.type == "cpu":
        return filtfilt_plain(x)
    t_len = x.shape[-1]
    rows = x.reshape(-1, t_len)
    n = rows.shape[0]
    out = torch.empty_like(rows)
    if n == 0:
        return out.reshape(x.shape)
    if n * (t_len + 2 * pad) >= 2**31:
        raise ValueError(f"too many samples for one launch: {n} rows of {t_len}")
    work = torch.empty((n, t_len + 2 * pad), dtype=torch.float32, device=x.device)
    sos, zi = build.device_tables(kernel_tables, x.device)[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(rows.data_ptr(), n, t_len, pad, sos, zi, work.data_ptr(), out.data_ptr(), stream)
    build.check(rc, "filtfilt")
    filtfilt.launches += 1
    return out.reshape(x.shape)


filtfilt.launches = 0
