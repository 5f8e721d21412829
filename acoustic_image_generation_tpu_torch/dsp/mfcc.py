"""Batched 12-coefficient MFCC frontend, plain PyTorch.

Counterpart of ``acoustic_image_generation_tpu/dsp/mfcc.py``:

    frame (.., 1024) -> Tukey(0.75) window -> |rfft(1024)|^2 drop Nyquist
    -> (512,) power -> mel filterbank (512,24) -> floor 1e-3 -> log
    -> DCT-II (24,12) * sqrt(2/24) -> sinusoidal lifter(22) -> (12,)

The DFT is two f32 GEMMs against cos/sin bases with the window folded in.
Samples are int16-range, so the DFT sums cancel heavily: a reduced-precision
product (TF32, bf16) puts O(1) errors into the MFCCs. Callers on CUDA must
keep ``torch.backends.cuda.matmul.allow_tf32`` off for this function.
``ops/mfcc_kernel.py`` holds the fused CUDA kernel that the serving path
runs on the card; this function is its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.dsp import mel as mel_mod


@functools.cache
def frontend_constants() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(cos (1024,512), sin (1024,512), mel (512,24), dct_lifter (24,12)),
    built in float64 with the Tukey window folded into the DFT bases, then
    cast to float32."""
    c = mel_mod.constants()
    n = mel_mod.N_SAMPLES
    k = np.arange(n)[:, None] * np.arange(mel_mod.FFT_LEN)[None, :] * (2.0 * np.pi / n)
    cos_b = np.cos(k) * c.window[:, None]
    sin_b = -np.sin(k) * c.window[:, None]
    return (
        cos_b.astype(np.float32),
        sin_b.astype(np.float32),
        np.asarray(c.filter_mat, np.float32),
        np.asarray(c.dct_lifter, np.float32),
    )


@functools.cache
def device_constants(device: torch.device) -> tuple[torch.Tensor, ...]:
    """``frontend_constants`` as contiguous f32 tensors, uploaded once per
    device: private copies, never views of the cached numpy arrays (on the
    CPU a view would let an in-place op on one poison every later call)."""
    return tuple(torch.from_numpy(a).to(device, copy=True) for a in frontend_constants())


def mfcc_from_frames(frames: torch.Tensor) -> torch.Tensor:
    """(..., 1024) float or int samples -> (..., 12) float32 MFCCs."""
    cos_b, sin_b, mel_b, dct_b = device_constants(frames.device)
    x = frames.to(torch.float32)
    re = x @ cos_b
    im = x @ sin_b
    power = re * re + im * im
    melspec = torch.clamp_min(power @ mel_b, mel_mod.MELSPEC_FLOOR)
    coeffs = torch.log(melspec) @ dct_b
    # The reference zeroes NaN/Inf coefficients.
    return torch.where(torch.isfinite(coeffs), coeffs, torch.zeros_like(coeffs))


def mfcc_numpy_oracle(frames: np.ndarray) -> np.ndarray:
    """Host NumPy reference of the same chain, step by step as the original
    data loader computes it ((N,1024) -> (N,12) float32)."""
    c = mel_mod.constants()
    n = frames.shape[0]
    raw = frames.astype(np.float64) * c.window[None, :]
    fftdata = np.abs(np.fft.rfft(raw, mel_mod.N_SAMPLES, axis=1))[:, :-1]
    power = fftdata**2
    melspec = power @ c.filter_mat
    melspec[melspec < mel_mod.MELSPEC_FLOOR] = mel_mod.MELSPEC_FLOOR
    melspec = np.log(melspec)
    coeffs = melspec @ c.dct_base
    coeffs *= c.mfnorm
    coeffs *= c.lifter
    coeffs[np.isnan(coeffs)] = 0
    coeffs[np.isinf(coeffs)] = 0
    return np.float32(coeffs.reshape(n, mel_mod.MFCC_NUM))
