"""The STFT magnitude kernel (``csrc/stft.cu``) and its wrapper.

Port of ``acoustic_image_generation_tpu/ops/pallas_stft.py::stft_pallas``.
The plain version is ``dsp.spectrogram.stft_magnitude``; both use the same
float32 bases (``dsp.spectrogram._dft_bases``), which the kernel reads
zero-padded to (256, 320). A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec
from acoustic_image_generation_tpu_torch.ops import build

stft_plain = spec.stft_magnitude
PAD_ROWS, PAD_BINS = 256, 320  # the kernel's zero-padded basis shape


@functools.cache
def _entry():
    fn = build.library("stft").aig_stft
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def padded_bases(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's f32 bases, zero-padded to (256, 320), once per
    device."""
    pad = (0, PAD_BINS - spec.NUM_BINS, 0, PAD_ROWS - spec.FRAME_LENGTH)
    return tuple(F.pad(b, pad).contiguous() for b in spec.device_bases(device))


def stft(wav: torch.Tensor) -> torch.Tensor:
    """(..., 12288) float32 audio -> (..., 99, 257) float32 |STFT|, the
    246/122/512 geometry of ``dsp.spectrogram``.

    On the CPU: the plain version. On CUDA: one launch of the kernel,
    counted in ``stft.launches``. Raises ``ValueError`` for another device,
    another dtype or length, or a non-contiguous or unaligned input."""
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
    cos_b, sin_b = padded_bases(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry()(x.data_ptr(), n, cos_b.data_ptr(), sin_b.data_ptr(), out.data_ptr(), stream)
    build.check(rc, "stft")
    stft.launches += 1
    return out.reshape(*lead, spec.NUM_FRAMES, spec.NUM_BINS)


stft.launches = 0
