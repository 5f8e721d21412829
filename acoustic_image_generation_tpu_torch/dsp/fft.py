"""Constant tables of the frontends' FFT kernels (NumPy, float64).

``csrc/mfcc.cu`` and ``csrc/stft.cu`` compute their real DFTs as radix
FFTs in shared memory: an n-point real FFT is an n/2-point complex FFT over
the (even, odd) sample pairs, run as Stockham passes of the radices below,
then a real-split step. Pass p of radix R (``ns`` = the product of the
radices before it) takes butterfly j (0 <= j < N/R) from points
``j + r N/R``, multiplies point r by ``twiddles(N)[r k N/(ns R)]`` with
``k = j mod ns``, takes the R-point DFT and writes point r to
``(j // ns) ns R + k + r ns``; after the last pass the points are in natural
order. The kernels compute in float64 and read these tables in float64.
"""

from __future__ import annotations

import numpy as np

MFCC_RADICES = (8, 8, 8)  # 512 complex points: the 1024-point real FFT
STFT_RADICES = (8, 8, 4)  # 256 complex points: the 512-point real FFT


def twiddles(n: int) -> np.ndarray:
    """(n,) complex128 ``exp(-2 pi i m / n)``."""
    return np.exp(-2j * np.pi * np.arange(n) / n)


def real_split(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(A, B), each (n/2 + 1,) complex128: with Z the n/2-point FFT of
    ``x[0::2] + i x[1::2]``, bin k of the n-point real FFT of x is
    ``Z[k] A[k] + conj(Z[(n/2 - k) mod n/2]) B[k]``."""
    w = np.exp(-2j * np.pi * np.arange(n // 2 + 1) / n)
    return (1 - 1j * w) / 2, (1 + 1j * w) / 2


def mel_spans(filter_mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The (bins, bands) filterbank as spans: ``spans`` (bands, 3) int32 of
    (first bin, bin count, offset into ``weights``) and ``weights`` (nnz,)
    float64, each band's nonzero weights in bin order. Raises if a band's
    nonzeros are not contiguous."""
    spans, weights = [], []
    offset = 0
    for col in filter_mat.T:
        nz = np.flatnonzero(col)
        if nz.size and nz[-1] - nz[0] + 1 != nz.size:
            raise ValueError("a mel band's nonzero weights are not contiguous")
        first = int(nz[0]) if nz.size else 0
        spans.append((first, nz.size, offset))
        weights.append(col[first:first + nz.size])
        offset += nz.size
    return np.asarray(spans, np.int32), np.concatenate(weights).astype(np.float64)


def as_pairs(c: np.ndarray) -> np.ndarray:
    """Complex (...,) -> float64 (..., 2) of (real, imaginary): the layout of
    a CUDA ``double2``."""
    return np.ascontiguousarray(np.stack([c.real, c.imag], axis=-1), dtype=np.float64)
