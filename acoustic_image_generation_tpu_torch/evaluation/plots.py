"""Qualitative channel grids: the 12 MFCC channels of a real and a
reconstructed acoustic image side by side, and their inverse energy maps.

Counterpart of ``acoustic_image_generation_tpu/evaluation/plots.py``; host
matplotlib, imported when a render runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.evaluation.overlay import _pyplot


def save_channel_grid(out_path: str, real: np.ndarray, reconstructed: np.ndarray) -> str:
    """Two (36, 48, 12) images: the channels of each in a 4x3 block, the
    two ``find_logen`` energy maps in the last column."""
    plt = _pyplot()
    fig, axs = plt.subplots(4, 7, figsize=(14, 7))
    for c in range(12):
        row, col = divmod(c, 3)
        for offset, img, name in ((0, real, "real"), (3, reconstructed, "gen")):
            ax = axs[row][col + offset]
            ax.imshow(img[..., c], cmap="viridis")
            ax.axis("off")
            ax.set_title(f"{name} ch{c}", fontsize=7)
    for r, (name, img) in enumerate([("real energy", real), ("gen energy", reconstructed)]):
        ax = axs[r][6]
        ax.imshow(find_logen(torch.from_numpy(np.asarray(img, np.float32))[None])[0].numpy(), cmap="jet")
        ax.axis("off")
        ax.set_title(name, fontsize=7)
    for r in (2, 3):
        axs[r][6].axis("off")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
