"""STFT magnitude spectrogram frontend (the audio VAE's input), plain
PyTorch.

Counterpart of ``acoustic_image_generation_tpu/dsp/spectrogram.py``: frame
length 246, frame step 122, FFT length 512, periodic Hann window, |.|. One
second of 12288 Hz audio -> (99, 257). The rFFT is two f32 GEMMs against
cos/sin bases with the window folded in, built in float64 and cast to
float32. The sums cancel heavily on int16-range audio, so a reduced
precision product (TF32, bf16) puts errors of about 1e-3 of the peak into
the magnitudes: callers on CUDA keep ``torch.backends.cuda.matmul.allow_tf32``
off for this function.

``ops/stft.py`` holds the CUDA kernel that the embedding path runs on the
card; ``stft_magnitude`` here is its plain version. ``stft_magnitude``
also takes another geometry (``frame_length``, ``frame_step``,
``fft_length``), as the TUT loader's 440/219/512 (``data/tut.py``); the
kernel serves the default one only, so another geometry stays this plain
product on every device, as JAX computes it outside any Pallas kernel.
``resize_frames`` is the bilinear 99 -> 193 frame resize of the embedding
task (``jax.image.resize`` with ``"bilinear"``: half-pixel centres, no
antialiasing when upsampling).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

FRAME_LENGTH = 246
FRAME_STEP = 122
FFT_LENGTH = 512
SAMPLES_PER_SECOND = 12 * 1024
NUM_FRAMES = 1 + (SAMPLES_PER_SECOND - FRAME_LENGTH) // FRAME_STEP  # 99
NUM_BINS = FFT_LENGTH // 2 + 1  # 257
RESIZED_FRAMES = 193  # the large audio VAE's input height


def hann_periodic(n: int = FRAME_LENGTH) -> np.ndarray:
    """Periodic Hann window (``tf.signal``'s default), float64."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.cache
def _dft_bases(frame_length: int = FRAME_LENGTH, fft_length: int = FFT_LENGTH):
    """Windowed real-DFT bases (frame_length, fft_length // 2 + 1), built in
    float64 and cast to float32: ``cos(k n) w(n)`` and ``-sin(k n) w(n)``."""
    window = hann_periodic(frame_length)
    k = np.arange(frame_length)[:, None] * np.arange(fft_length // 2 + 1)[None, :] * (2.0 * np.pi / fft_length)
    cos_b = np.cos(k) * window[:, None]
    sin_b = -np.sin(k) * window[:, None]
    return cos_b.astype(np.float32), sin_b.astype(np.float32)


@functools.cache
def device_bases(device: torch.device, frame_length: int = FRAME_LENGTH,
                 fft_length: int = FFT_LENGTH) -> tuple[torch.Tensor, torch.Tensor]:
    """``_dft_bases`` of one geometry as f32 tensors, uploaded once per
    device: private copies, never views of the cached numpy arrays (on the
    CPU a view would let an in-place op on one poison every later call)."""
    return tuple(torch.from_numpy(a).to(device, copy=True) for a in _dft_bases(frame_length, fft_length))


def stft_magnitude(wav: torch.Tensor, *, frame_length: int = FRAME_LENGTH, frame_step: int = FRAME_STEP,
                   fft_length: int = FFT_LENGTH) -> torch.Tensor:
    """|STFT| of (..., num_samples) audio -> (..., frames, fft_length // 2 +
    1) float32; (..., 99, 257) over 12288 samples at the default geometry."""
    frames = wav.to(torch.float32).unfold(-1, frame_length, frame_step)
    cos_b, sin_b = device_bases(wav.device, frame_length, fft_length)
    re = frames @ cos_b
    im = frames @ sin_b
    return torch.sqrt(re * re + im * im)


def stft_magnitude_numpy_oracle(wav: np.ndarray, *, frame_length: int = FRAME_LENGTH, frame_step: int = FRAME_STEP,
                                fft_length: int = FFT_LENGTH) -> np.ndarray:
    """Host oracle mirroring ``tf.signal.stft`` step by step (float64 FFT,
    float32 out)."""
    num_frames = 1 + (wav.shape[-1] - frame_length) // frame_step
    window = hann_periodic(frame_length)
    out = np.empty((*wav.shape[:-1], num_frames, fft_length // 2 + 1), np.float32)
    for f in range(num_frames):
        seg = wav[..., f * frame_step: f * frame_step + frame_length] * window
        out[..., f, :] = np.abs(np.fft.rfft(seg, fft_length, axis=-1))
    return out


def resize_frames(spec: torch.Tensor, frames: int = RESIZED_FRAMES) -> torch.Tensor:
    """(N, T, B) -> (N, frames, B): bilinear with half-pixel centres along
    the frame axis (the bin axis keeps its size, so it is unchanged), as
    ``jax.image.resize(spec, (N, frames, B), "bilinear")``. Torch's
    antialiased path rounds otherwise (about 2e-4 on magnitudes of 50), so
    it is off: upsampling needs no antialiasing."""
    out = F.interpolate(spec[:, None], size=(frames, spec.shape[-1]), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[:, 0]
