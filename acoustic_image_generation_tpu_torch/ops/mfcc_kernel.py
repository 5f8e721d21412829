"""The fused MFCC kernel (``csrc/mfcc.cu``) and its wrapper.

Port of ``acoustic_image_generation_tpu/ops/pallas_mfcc.py::mfcc_pallas``.
The plain version is ``dsp.mfcc.mfcc_from_frames``. A tensor on the CPU
takes the plain version; a CUDA tensor launches the kernel or raises. The
kernel runs an FFT (``dsp.fft``) on the tables of ``kernel_tables``, which
the wrapper uploads once per device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.dsp import fft
from acoustic_image_generation_tpu_torch.dsp import mel as mel_mod
from acoustic_image_generation_tpu_torch.dsp.mfcc import mfcc_from_frames
from acoustic_image_generation_tpu_torch.ops import build

mfcc_plain = mfcc_from_frames


@functools.cache
def kernel_tables() -> dict[str, np.ndarray]:
    """The tables ``csrc/mfcc.cu`` reads, in the order of its arguments:
    float64, built in float64 (the mel spans int32)."""
    c = mel_mod.constants()
    split_a, split_b = fft.real_split(mel_mod.N_SAMPLES)
    spans, weights = fft.mel_spans(c.filter_mat)
    return dict(
        twiddles=fft.as_pairs(fft.twiddles(mel_mod.N_SAMPLES // 2)),
        split_a=fft.as_pairs(split_a[:mel_mod.FFT_LEN]),  # the Nyquist bin is dropped
        split_b=fft.as_pairs(split_b[:mel_mod.FFT_LEN]),
        window=np.asarray(c.window, np.float64),
        mel_spans=spans,
        mel_weights=weights,
        dct=np.ascontiguousarray(c.dct_lifter, np.float64),
    )


@functools.cache
def _entry():
    fn = build.library("mfcc").aig_mfcc
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, *[p] * len(kernel_tables()), p, p]
    fn.restype = ctypes.c_int
    return fn


def mfcc(frames: torch.Tensor) -> torch.Tensor:
    """(..., 1024) float32 samples -> (..., 12) float32 MFCCs.

    On CUDA: one launch of the fused kernel, counted in ``mfcc.launches``.
    """
    if frames.dtype != torch.float32:
        raise TypeError(f"mfcc takes float32 frames, got {frames.dtype}")
    if frames.dim() < 1 or frames.shape[-1] != mel_mod.N_SAMPLES:
        raise ValueError(f"mfcc takes (..., {mel_mod.N_SAMPLES}) frames, got {tuple(frames.shape)}")
    if frames.device.type == "cpu":
        return mfcc_plain(frames)
    if frames.device.type != "cuda":
        raise ValueError(f"mfcc runs on cpu or cuda, got {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("mfcc takes contiguous frames")
    if frames.data_ptr() % 16:
        raise ValueError("mfcc takes 16-byte aligned frames")
    lead = frames.shape[:-1]
    x = frames.reshape(-1, mel_mod.N_SAMPLES)
    n = x.shape[0]
    out = torch.empty((n, mel_mod.MFCC_NUM), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.reshape(*lead, mel_mod.MFCC_NUM)
    if n >= 2**31:
        raise ValueError(f"too many frames for one launch: {n}")
    tables = build.device_tables(kernel_tables, x.device)[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(x.data_ptr(), n, *tables, out.data_ptr(), stream)
    build.check(rc, "mfcc")
    mfcc.launches += 1
    return out.reshape(*lead, mel_mod.MFCC_NUM)


mfcc.launches = 0
