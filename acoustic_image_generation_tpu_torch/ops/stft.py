"""The STFT magnitude kernel (``csrc/stft.cu``) and its wrapper.

Port of ``acoustic_image_generation_tpu/ops/pallas_stft.py::stft_pallas``.
The plain version is ``dsp.spectrogram.stft_magnitude`` (two float32
products against the DFT bases); the kernel runs an FFT (``dsp.fft``) in
float64 on the tables of ``kernel_tables``, which the wrapper uploads once
per device, so the two agree to the plain version's rounding, not bit for
bit. A tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.dsp import fft
from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec
from acoustic_image_generation_tpu_torch.ops import build

stft_plain = spec.stft_magnitude


@functools.cache
def kernel_tables() -> dict[str, np.ndarray]:
    """The tables ``csrc/stft.cu`` reads, in the order of its arguments,
    float64."""
    split_a, split_b = fft.real_split(spec.FFT_LENGTH)
    return dict(
        twiddles=fft.as_pairs(fft.twiddles(spec.FFT_LENGTH // 2)),
        split_a=fft.as_pairs(split_a),
        split_b=fft.as_pairs(split_b),
        window=spec.hann_periodic(),
    )


@functools.cache
def _entry():
    fn = build.library("stft").aig_stft
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, *[p] * len(kernel_tables()), p, p]
    fn.restype = ctypes.c_int
    return fn


def stft(wav: torch.Tensor, *, frame_length: int = spec.FRAME_LENGTH, frame_step: int = spec.FRAME_STEP,
         fft_length: int = spec.FFT_LENGTH) -> torch.Tensor:
    """(..., 12288) float32 audio -> (..., 99, 257) float32 |STFT|, the
    246/122/512 geometry of ``dsp.spectrogram``.

    On the CPU: the plain version. On CUDA: one launch of the kernel,
    counted in ``stft.launches``. Raises ``ValueError`` for another
    geometry, another device, another dtype or length, or a non-contiguous
    or unaligned input."""
    geometry = (frame_length, frame_step, fft_length)
    if geometry != (spec.FRAME_LENGTH, spec.FRAME_STEP, spec.FFT_LENGTH):
        raise ValueError(
            f"stft serves the {spec.FRAME_LENGTH}/{spec.FRAME_STEP}/{spec.FFT_LENGTH} geometry only, got "
            f"{frame_length}/{frame_step}/{fft_length}: the kernel's FFT plan and tables are built for one "
            "512-point transform of 246-sample frames; call dsp.spectrogram.stft_magnitude with the geometry "
            "(a plain product on any device, as JAX computes it outside Pallas)")
    if wav.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stft runs on cpu or cuda, got {wav.device}")
    if wav.dtype != torch.float32:
        raise ValueError(f"stft takes float32 audio, got {wav.dtype}")
    if wav.dim() < 1 or wav.shape[-1] != spec.SAMPLES_PER_SECOND:
        raise ValueError(f"stft takes (..., {spec.SAMPLES_PER_SECOND}) audio, got {tuple(wav.shape)}")
    if not wav.is_contiguous():
        raise ValueError("stft takes contiguous audio")
    if wav.device.type == "cpu":
        return stft_plain(wav)
    if wav.data_ptr() % 16:
        raise ValueError("stft takes 16-byte aligned audio")
    lead = wav.shape[:-1]
    x = wav.reshape(-1, spec.SAMPLES_PER_SECOND)
    n = x.shape[0]
    out = torch.empty((n, spec.NUM_FRAMES, spec.NUM_BINS), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.reshape(*lead, spec.NUM_FRAMES, spec.NUM_BINS)
    if n >= 2**31:
        raise ValueError(f"too many seconds for one launch: {n}")
    tables = build.device_tables(kernel_tables, x.device)[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(x.data_ptr(), n, *tables, out.data_ptr(), stream)
    build.check(rc, "stft")
    stft.launches += 1
    return out.reshape(*lead, spec.NUM_FRAMES, spec.NUM_BINS)


stft.launches = 0
