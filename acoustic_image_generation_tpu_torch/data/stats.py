"""Spectrogram normalization statistics.

Counterpart of ``acoustic_image_generation_tpu/data/stats.py``: the
reference z-normalizes its STFT spectrograms with a global per-bin mean and
std from a ``stats2s/`` directory beside the list file. ``compute_
spectrogram_stats`` takes them in one pass over a loader: each batch's
seconds go to ``device`` (``cuda`` unless the caller passes ``cpu``) and
through ``ops.stft.stft`` (the ``stft`` kernel on the card, its plain
version on the CPU); the sums are JAX's, f32 numpy on the host, per bin, so
the statistics differ from JAX's only by the ``stft``'s own tolerance.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import resolve_device
from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND
from acoustic_image_generation_tpu_torch.ops.stft import stft

MEAN_FILE = "global_mean_prod_2s.npy"
STD_FILE = "global_std_dev_prod_2s.npy"


def compute_spectrogram_stats(loader, max_batches: int | None = None, *, device="cuda"):
    """Global per-bin ``(mean, std)`` (99, 257) f32 of the per-second
    magnitude spectrograms of the valid clips of ``loader.batches(0)``."""
    device = resolve_device(device)
    total = total_sq = None
    count = 0
    for i, raw in enumerate(loader.batches(0)):
        if max_batches is not None and i >= max_batches:
            break
        wav = raw.audio[: raw.valid].reshape(-1, SAMPLES_PER_SECOND).astype(np.float32)
        spec = stft(torch.from_numpy(wav).to(device)).cpu().numpy()
        s = spec.sum(axis=0)
        sq = (spec**2).sum(axis=0)
        total = s if total is None else total + s
        total_sq = sq if total_sq is None else total_sq + sq
        count += spec.shape[0]
    mean = total / count
    var = total_sq / count - mean**2
    return mean.astype(np.float32), np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)


def save_stats(stats_dir: str, mean: np.ndarray, std: np.ndarray) -> None:
    """The ``stats2s`` file names (``global_*_prod_2s.npy``)."""
    os.makedirs(stats_dir, exist_ok=True)
    np.save(os.path.join(stats_dir, MEAN_FILE), mean)
    np.save(os.path.join(stats_dir, STD_FILE), std)


def load_stats(stats_dir: str) -> tuple[np.ndarray, np.ndarray]:
    return np.load(os.path.join(stats_dir, MEAN_FILE)), np.load(os.path.join(stats_dir, STD_FILE))


def normalize_spectrogram(spec: torch.Tensor, mean, std) -> torch.Tensor:
    """z-norm of ``spec`` (..., 99, 257) with the global statistics, in
    ``spec``'s dtype on its device (``mean`` and ``std``: numpy arrays, or
    tensors, which are used in place when they already match)."""
    as_t = lambda a: torch.as_tensor(a, dtype=spec.dtype, device=spec.device)
    return (spec - as_t(mean)) / as_t(std)
