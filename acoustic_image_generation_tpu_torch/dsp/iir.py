"""Butterworth low-pass design and zero-phase filtering (filtfilt).

Counterpart of ``acoustic_image_generation_tpu/dsp/iir.py``. The reference
builds the "silence" MFCC branch of the correspondence task by low-pass
filtering each 1024-sample frame at 125 Hz, order 10, with SciPy's
``filtfilt`` defaults.

- The design half is numpy float64, a copy of the JAX package's:
  ``butter_lowpass`` ((b, a), bit for bit SciPy's ``butter``),
  ``butter_lowpass_sos`` (conjugate-pole biquads), ``lfilter_zi``,
  ``_default_sos`` (the sections and their steady-state ``zi``) and the
  host path ``filtfilt_numpy`` over (b, a).
- ``filtfilt`` is the plain PyTorch counterpart of ``filtfilt_jax``, the
  path that ``preprocess_batch`` runs: the biquad cascade in direct form II
  transposed in float32 (the (b, a) form is unusable in float32 at this
  cutoff), odd extension by ``padlen = 3 * (2 * sections + 1) = 33``,
  ``zi`` scaled by the first sample, a forward pass, then a pass over the
  reversed output. Every multiply and add is rounded on its own, in the
  order of ``_sosfilt_scan``; ``ops/sosfilt.py``'s CUDA kernel does the
  same arithmetic and is bit-equal to it.

The sos path and the (b, a) host path differ by up to about 10% at this
order and cutoff (the (b, a) polynomial is ill-conditioned even in
float64); the port, like the JAX package's device path, computes the sos
filter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_CUTOFF_HZ = 125.0
DEFAULT_ORDER = 10
SAMPLE_RATE = 12288


def butter_lowpass(order: int, wn: float) -> tuple[np.ndarray, np.ndarray]:
    """Digital Butterworth low-pass (b, a); ``wn`` normalized to Nyquist=1."""
    k = np.arange(-order + 1, order, 2)
    poles = -np.exp(1j * np.pi * k / (2 * order))
    gain = 1.0

    # pre-warp and scale (lp2lp), then the bilinear transform at fs=2
    fs = 2.0
    warped = 2 * fs * np.tan(np.pi * wn / fs)
    poles = warped * poles
    gain *= warped**order

    fs2 = 2.0 * fs
    poles_d = (fs2 + poles) / (fs2 - poles)
    zeros_d = -np.ones(order)
    gain_d = np.real(gain / np.prod(fs2 - poles))

    b = gain_d * np.real(np.poly(zeros_d))
    a = np.real(np.poly(poles_d))
    return b, a


@functools.lru_cache(maxsize=8)
def _default_ba(sample_rate: int, cutoff: float, order: int):
    nyq = 0.5 * sample_rate
    return butter_lowpass(order, cutoff / nyq)


def butter_lowpass_sos(order: int, wn: float) -> np.ndarray:
    """Digital Butterworth low-pass as cascaded biquads, (order//2, 6):
    conjugate poles paired by the size of their imaginary part, zeros at
    z=-1, the gain on the first section."""
    assert order % 2 == 0, "even order only (the reference uses 10)"
    k = np.arange(-order + 1, order, 2)
    poles = -np.exp(1j * np.pi * k / (2 * order))
    fs = 2.0
    warped = 2 * fs * np.tan(np.pi * wn / fs)
    poles = warped * poles
    gain = warped**order
    fs2 = 2.0 * fs
    poles_d = (fs2 + poles) / (fs2 - poles)
    gain_d = np.real(gain / np.prod(fs2 - poles))

    upper = poles_d[np.imag(poles_d) > 0]
    upper = upper[np.argsort(np.abs(np.imag(upper)))]
    n_sec = order // 2
    sos = np.zeros((n_sec, 6))
    for i, p in enumerate(upper):
        sos[i, 0:3] = [1.0, 2.0, 1.0]
        sos[i, 3:6] = [1.0, -2 * np.real(p), np.abs(p) ** 2]
    sos[0, 0:3] *= gain_d
    return sos


@functools.lru_cache(maxsize=8)
def _default_sos(sample_rate: int, cutoff: float, order: int) -> tuple:
    """The sections (n_sec, 6) and SciPy's ``sosfilt_zi`` (n_sec, 2), float64:
    each section's ``lfilter_zi`` scaled by the DC gain of the ones before."""
    nyq = 0.5 * sample_rate
    sos = butter_lowpass_sos(order, cutoff / nyq)
    n_sec = sos.shape[0]
    zi = np.zeros((n_sec, 2))
    scale = 1.0
    for k in range(n_sec):
        b, a = sos[k, :3], sos[k, 3:]
        zi[k] = scale * lfilter_zi(b, a)
        scale *= b.sum() / a.sum()
    return sos, zi


def lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state initial conditions for a step input (scipy.signal.lfilter_zi)."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    a = a / a[0]
    b = b / a[0] if a[0] != 1.0 else b
    n = len(a)
    comp = np.zeros((n - 1, n - 1))
    comp[0, :] = -a[1:] / a[0]
    comp[1:, :-1] = np.eye(n - 2)
    iminus_a = np.eye(n - 1) - comp.T
    rhs = b[1:] - a[1:] * b[0]
    return np.linalg.solve(iminus_a, rhs)


def _lfilter_np(b, a, x, zi):
    """Direct form II transposed over one 1-D signal, float64."""
    n_ord = len(a) - 1
    z = zi.copy()
    y = np.empty_like(x)
    for i in range(len(x)):
        xi = x[i]
        yi = b[0] * xi + z[0]
        for j in range(n_ord - 1):
            z[j] = b[j + 1] * xi + z[j + 1] - a[j + 1] * yi
        z[n_ord - 1] = b[n_ord] * xi - a[n_ord] * yi
        y[i] = yi
    return y


def _odd_ext(x: np.ndarray, n: int) -> np.ndarray:
    left = 2 * x[..., :1] - x[..., n:0:-1]
    right = 2 * x[..., -1:] - x[..., -2: -n - 2: -1]
    return np.concatenate((left, x, right), axis=-1)


def filtfilt_numpy(x: np.ndarray, sample_rate: int = SAMPLE_RATE, cutoff: float = DEFAULT_CUTOFF_HZ,
                   order: int = DEFAULT_ORDER) -> np.ndarray:
    """Zero-phase Butterworth low-pass over the last axis on the host, over
    (b, a) as the reference's ``butter_lowpass_filter``: SciPy's filtfilt
    defaults, the output cast to float32."""
    b, a = _default_ba(sample_rate, cutoff, order)
    zi = lfilter_zi(b, a)
    padlen = 3 * max(len(a), len(b))
    x = np.asarray(x, dtype=np.float64)
    flat = x.reshape(-1, x.shape[-1])
    out = np.empty_like(flat)
    for i, sig in enumerate(flat):
        ext = _odd_ext(sig, padlen)
        y = _lfilter_np(b, a, ext, zi * ext[0])
        y = _lfilter_np(b, a, y[::-1], zi * y[-1])
        out[i] = y[::-1][padlen:-padlen]
    return np.float32(out.reshape(x.shape))


@functools.lru_cache(maxsize=8)
def tables_f32(sample_rate: int = SAMPLE_RATE, cutoff: float = DEFAULT_CUTOFF_HZ,
               order: int = DEFAULT_ORDER) -> tuple[np.ndarray, np.ndarray]:
    """The sections (n_sec, 6) and ``zi`` (n_sec, 2) rounded to float32, as
    ``filtfilt_jax`` rounds them (``jnp.asarray(sos, float32)``)."""
    sos, zi = _default_sos(sample_rate, cutoff, order)
    return sos.astype(np.float32), zi.astype(np.float32)


def padlen(order: int = DEFAULT_ORDER) -> int:
    """The odd extension's length on each side: 3 * (2 * sections + 1)."""
    return 3 * (2 * (order // 2) + 1)


def _sosfilt(sos: np.ndarray, ext: torch.Tensor, zi: np.ndarray, x0: torch.Tensor) -> torch.Tensor:
    """Biquad cascade, direct form II transposed, over (B, L) float32 rows,
    one time step at a time (``_sosfilt_scan``): state ``zi * x0`` per
    section, each multiply and add rounded on its own."""
    coef = [[float(v) for v in row] for row in sos]
    z0 = [float(zi[k, 0]) * x0 for k in range(len(coef))]
    z1 = [float(zi[k, 1]) * x0 for k in range(len(coef))]
    out = torch.empty_like(ext)
    for t in range(ext.shape[1]):
        cur = ext[:, t]
        for k, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            y = b0 * cur + z0[k]
            z0[k] = b1 * cur + z1[k] - a1 * y
            z1[k] = b2 * cur - a2 * y
            cur = y
        out[:, t] = cur
    return out


def odd_extend(flat: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T) -> (B, T + 2n): ``2 x[0] - x[n..1]``, x, ``2 x[-1] - x[-2..-n-1]``."""
    t = flat.shape[1]
    left = 2 * flat[:, :1] - flat[:, 1:n + 1].flip(-1)
    right = 2 * flat[:, -1:] - flat[:, t - n - 1:t - 1].flip(-1)
    return torch.cat([left, flat, right], dim=1)


def filtfilt(x: torch.Tensor, sample_rate: int = SAMPLE_RATE, cutoff: float = DEFAULT_CUTOFF_HZ,
             order: int = DEFAULT_ORDER) -> torch.Tensor:
    """Zero-phase Butterworth low-pass over the last axis of ``x`` (float32
    out), the plain version: the sos cascade forward over the odd
    extension, then over the reversed output, trimmed. A Python loop over
    the time steps: ``ops.sosfilt.filtfilt`` runs it as one kernel on the
    card."""
    sos, zi = tables_f32(sample_rate, cutoff, order)
    n = padlen(order)
    shape = x.shape
    flat = x.to(torch.float32).reshape(-1, shape[-1])
    if shape[-1] <= n:
        raise ValueError(f"filtfilt needs more than {n} samples, got {shape[-1]}")
    ext = odd_extend(flat, n)
    y = _sosfilt(sos, ext, zi, ext[:, 0])
    y = y.flip(-1)
    y = _sosfilt(sos, y, zi, y[:, 0])
    return y.flip(-1)[:, n:-n].reshape(shape)
