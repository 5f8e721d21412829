"""Inverse MFCC -> spatial energy map (``find_logen``).

Counterpart of ``acoustic_image_generation_tpu/dsp/energy.py``: the 12 MFCC
channels of a (36,48,12) acoustic image are un-liftered, inverse-DCT'd back
to 24 mel log-energies, exponentiated, summed and inverted to one (36,48)
energy map. Computed in float32: ``exp`` of the un-liftered log-mel
overflows in bfloat16.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.dsp import mel as mel_mod


@functools.cache
def _constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    c = mel_mod.constants()
    lifter = torch.tensor(c.lifter, dtype=torch.float32, device=device)
    idct = torch.tensor(c.dct_base.T, dtype=torch.float32, device=device)
    return lifter, idct


def find_logen(mfcc: torch.Tensor) -> torch.Tensor:
    """(..., 12) MFCC coefficients -> (...) energy map, e.g. (B,36,48,12) ->
    (B,36,48), in float32."""
    lifter, idct = _constants(mfcc.device)
    x = mfcc.to(torch.float32) / lifter
    x = x * mel_mod.constants().mfnorm
    melspec = x @ idct  # (..., 24)
    return 1.0 / torch.sum(torch.exp(melspec), dim=-1)


def find_logen_numpy_oracle(mfcc: np.ndarray) -> np.ndarray:
    """Host oracle mirroring the original evaluation code line by line
    ((-1,12) -> (36,48))."""
    c = mel_mod.constants()
    m = np.reshape(mfcc, (-1, 12)).astype(np.float64).copy()
    m /= np.expand_dims(c.lifter, 0)
    m *= c.mfnorm
    melspec = np.dot(m, np.transpose(c.dct_base))
    melspec = np.exp(melspec)
    sumexp = np.sum(melspec, -1)
    sumexp = 1 / sumexp
    return np.reshape(sumexp, (36, 48))
