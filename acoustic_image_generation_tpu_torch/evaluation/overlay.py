"""Qualitative energy-overlay renders: the binarized above-mean energy map
of the real and generated acoustic images, upscaled and alpha-blended over
the grayscale video frame.

Counterpart of ``acoustic_image_generation_tpu/evaluation/overlay.py``: the
same figures, on the host with matplotlib, imported when a render runs (the
energy masks come from ``evaluation/iou.py`` on the device).
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _upscale_nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * mask.shape[0] // h).clip(max=mask.shape[0] - 1)
    xs = (np.arange(w) * mask.shape[1] // w).clip(max=mask.shape[1] - 1)
    return mask[np.ix_(ys, xs)]


def save_overlay_grid(out_path: str, video_frame: np.ndarray, real_mask: np.ndarray,
                      generated_mask: np.ndarray) -> str:
    """A 2x2 panel of the (224, 298, 3) frame in [0, 1] under the (36, 48)
    boolean masks: real, generated, union, intersection."""
    plt = _pyplot()
    gray = video_frame.mean(axis=-1)
    h, w = gray.shape
    panels = {
        "real": real_mask,
        "generated": generated_mask,
        "union": np.logical_or(real_mask, generated_mask),
        "intersect": np.logical_and(real_mask, generated_mask),
    }
    fig, axs = plt.subplots(2, 2, figsize=(6, 2.9))
    plt.tight_layout(pad=1.0)
    for ax, (title, mask) in zip(axs.flat, panels.items()):
        ax.imshow(gray, cmap="gray")
        ax.imshow(_upscale_nearest(mask.astype(float), h, w), cmap="viridis", alpha=0.7)
        ax.axis("off")
        ax.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def save_overlay_video_frames(out_dir: str, video_frames: np.ndarray, masks: np.ndarray, *,
                              prefix: str = "frame") -> list[str]:
    """One render per frame of (N, 224, 298, 3) frames in [0, 1] under their
    (N, 36, 48) boolean generated-energy masks, ``{prefix}_{i:05d}.png``."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    h, w = video_frames.shape[1:3]
    for i, (frame, mask) in enumerate(zip(video_frames, masks)):
        fig, ax = plt.subplots(figsize=(w / 100, h / 100), dpi=100)
        ax.imshow(frame.mean(axis=-1), cmap="gray")
        ax.imshow(_upscale_nearest(mask.astype(float), h, w), cmap="jet", alpha=0.5)
        ax.axis("off")
        fig.subplots_adjust(0, 0, 1, 1)
        path = os.path.join(out_dir, f"{prefix}_{i:05d}.png")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return paths
