"""Mel filterbank / DCT / liftering constants of the 12-coefficient MFCC
frontend (NumPy, float64).

Copy of ``acoustic_image_generation_tpu/dsp/mel.py``, quirks included: the
filterbank sample rate is ``2*HI_FREQ = 12800`` Hz, and the triangle edges
are floored onto a ``(fft_len-1)*2``-point lattice.
"""

from __future__ import annotations

import functools

import numpy as np

from acoustic_image_generation_tpu_torch.dsp.windows import tukey

LIFTER_NUM = 22
LO_FREQ = 0
HI_FREQ = 6400
FILTER_NUM = 24
MFCC_NUM = 12
FFT_LEN = 512
N_SAMPLES = 1024
TUKEY_ALPHA = 0.75
MELSPEC_FLOOR = 0.001


def mel_to_freq(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (np.exp(mel / 1127.0) - 1)


def freq_to_mel(freq: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1 + (freq / 700.0))


def create_filters(
    fft_len: int = FFT_LEN,
    filter_num: int = FILTER_NUM,
    lo_freq: float = LO_FREQ,
    hi_freq: float = HI_FREQ,
    samp_freq: float = 2 * HI_FREQ,
) -> np.ndarray:
    """HTK-style triangular mel filterbank, (fft_len, filter_num)."""
    filter_mat = np.zeros((fft_len, filter_num))

    lo_mel = freq_to_mel(np.asarray(lo_freq, dtype=float))
    hi_mel = freq_to_mel(np.asarray(hi_freq, dtype=float))

    mel_c = np.linspace(lo_mel, hi_mel, filter_num + 2)
    freq_c = mel_to_freq(mel_c)
    point_c = freq_c / float(samp_freq) * (fft_len - 1) * 2
    point_c = np.floor(point_c).astype("int")

    for f in range(filter_num):
        d1 = point_c[f + 1] - point_c[f]
        d2 = point_c[f + 2] - point_c[f + 1]
        filter_mat[point_c[f] : point_c[f + 1] + 1, f] = np.linspace(0, 1, d1 + 1)
        filter_mat[point_c[f + 1] : point_c[f + 2] + 1, f] = np.linspace(1, 0, d2 + 1)

    return filter_mat


def dct_basis(filter_num: int = FILTER_NUM, mfcc_num: int = MFCC_NUM) -> np.ndarray:
    """DCT-II basis without the DC term, (filter_num, mfcc_num)."""
    dct_base = np.zeros((filter_num, mfcc_num))
    for m in range(mfcc_num):
        dct_base[:, m] = np.cos(
            (m + 1) * np.pi / filter_num * (np.arange(filter_num) + 0.5)
        )
    return dct_base


def lifter_weights(
    mfcc_num: int = MFCC_NUM, lifter_num: int = LIFTER_NUM
) -> np.ndarray:
    """Sinusoidal liftering weights, (mfcc_num,)."""
    return 1 + (lifter_num / 2) * np.sin(np.pi * (1 + np.arange(mfcc_num)) / lifter_num)


def mfnorm(filter_num: int = FILTER_NUM) -> float:
    return float(np.sqrt(2.0 / filter_num))


class MfccConstants:
    """Bundle of all frontend constants, computed once."""

    def __init__(self) -> None:
        self.window = tukey(N_SAMPLES, alpha=TUKEY_ALPHA)  # (1024,)
        self.filter_mat = create_filters()  # (512, 24)
        self.dct_base = dct_basis()  # (24, 12)
        self.lifter = lifter_weights()  # (12,)
        self.mfnorm = mfnorm()
        # Combined post-log projection: melspec @ (dct_base * mfnorm * lifter)
        self.dct_lifter = self.dct_base * self.mfnorm * self.lifter[None, :]


@functools.cache
def constants() -> MfccConstants:
    return MfccConstants()
