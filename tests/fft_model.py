"""A numpy model of the FFT schedule that ``csrc/mfcc.cu`` and
``csrc/stft.cu`` run (``dsp.fft``): the same butterflies, passes, index
order and tables, so an index or twiddle error shows on the CPU without a
card. Used by ``test_torch_stft.py`` and ``test_torch_mfcc.py``."""

import numpy as np


def _dft4(a0, a1, a2, a3):
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, (a1 - a3) * -1j
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _dft8(v):
    e = _dft4(v[0], v[2], v[4], v[6])
    o = _dft4(v[1], v[3], v[5], v[7])
    h = np.sqrt(0.5)
    o[1] = ((o[1].real + o[1].imag) + 1j * (o[1].imag - o[1].real)) * h  # * (1 - i) / sqrt(2)
    o[2] = o[2] * -1j
    o[3] = ((o[3].imag - o[3].real) - 1j * (o[3].real + o[3].imag)) * h  # * (-1 - i) / sqrt(2)
    return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]


def stockham(z, radices, tw):
    """The kernels' Stockham passes over the last axis of ``z`` (complex),
    with the twiddle table ``tw``; returns the FFT in natural order."""
    n, ns = z.shape[-1], 1
    for radix in radices:
        j = np.arange(n // radix)
        k = j % ns
        v = [z[..., j + r * (n // radix)] for r in range(radix)]
        if ns > 1:
            v = [v[0]] + [v[r] * tw[r * k * (n // (ns * radix))] for r in range(1, radix)]
        v = _dft8(v) if radix == 8 else _dft4(*v)
        out = np.empty_like(z)
        base = (j // ns) * ns * radix + k
        for r in range(radix):
            out[..., base + r * ns] = v[r]
        z, ns = out, ns * radix
    return z


def real_split(z_fft, split_a, split_b):
    """Bins 0..len(split_a)-1 of the real FFT from the half-size complex
    FFT of the (even, odd) sample pairs, as the kernels compute them."""
    m = z_fft.shape[-1]
    k = np.arange(split_a.shape[0])
    return z_fft[..., k % m] * split_a + np.conj(z_fft[..., (m - k) % m]) * split_b


def complex_table(pairs):
    return pairs[..., 0] + 1j * pairs[..., 1]
