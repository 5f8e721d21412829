"""Device preprocessing of raw frames.

Counterpart of ``acoustic_image_generation_tpu/data/preprocess.py``:

- acoustic: per-frame min-max over (H, W, C);
- MFCC: the frontend (``ops.mfcc_kernel.mfcc``: the fused CUDA kernel on
  the card, its plain version on the CPU), then per-frame min-max over the
  12 coefficients; skipped (``mfcc=False``) for a task that does not read
  it, where JAX's jitted step drops it as dead code;
- video: BGR channel flip, then /255;
- action and location labels, one per frame, as int32.

The Butterworth "filtered" branch only feeds the correspondence
augmentation, a training feature; it comes with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from acoustic_image_generation_tpu_torch.ops.mfcc_kernel import mfcc


class Batch(NamedTuple):
    """Model-ready frames (leading axis = frames)."""

    audio: torch.Tensor  # (N, 1024) float32 waveform
    mfcc: torch.Tensor | None  # (N, 12) in [0, 1]; None when skipped
    video: torch.Tensor  # (N, 224, 298, 3) in [0, 1]
    acoustic: torch.Tensor | None = None  # (N, 36, 48, C) in [0, 1]
    action: torch.Tensor | None = None  # (N,) int32
    location: torch.Tensor | None = None  # (N,) int32


def minmax_frame(x: torch.Tensor, dims) -> torch.Tensor:
    """Shift by the min, divide by the max of the shifted value."""
    x = x - torch.amin(x, dim=dims, keepdim=True)
    return x / torch.amax(x, dim=dims, keepdim=True)


def normalize_acoustic(acoustic: torch.Tensor) -> torch.Tensor:
    return minmax_frame(acoustic.to(torch.float32), dims=(-3, -2, -1))


def normalize_mfcc(coeffs: torch.Tensor) -> torch.Tensor:
    return minmax_frame(coeffs, dims=(-1,))


def normalize_video(video: torch.Tensor) -> torch.Tensor:
    """uint8 BGR -> RGB float32 in [0, 1]."""
    return torch.flip(video, dims=(-1,)).to(torch.float32) * (1.0 / 255.0)


def preprocess_batch(
    audio_raw: torch.Tensor,  # (N, 1024) int32
    video_raw: torch.Tensor,  # (N, 224, 298, 3) uint8
    acoustic_raw: torch.Tensor | None = None,  # (N, 36, 48, C)
    action: torch.Tensor | None = None,  # (N,) int
    location: torch.Tensor | None = None,  # (N,) int
    *,
    compute_filtered: bool = False,
    compute_mfcc: bool = True,
) -> Batch:
    """Raw decoded frames -> model-ready batch."""
    if compute_filtered:
        raise NotImplementedError(
            "the Butterworth 'filtered' MFCC branch is not ported yet"
        )
    wav = audio_raw.to(torch.float32)
    label = lambda t: None if t is None else t.to(torch.int32)
    return Batch(
        audio=wav,
        mfcc=normalize_mfcc(mfcc(wav.contiguous())) if compute_mfcc else None,
        video=normalize_video(video_raw),
        acoustic=None if acoustic_raw is None else normalize_acoustic(acoustic_raw),
        action=label(action),
        location=label(location),
    )


def tile_mfccmap(mfcc: torch.Tensor, h: int = 36, w: int = 48) -> torch.Tensor:
    """(N,12) -> (N,36,48,12) constant spatial map (a broadcast view)."""
    return mfcc[:, None, None, :].expand(mfcc.shape[0], h, w, mfcc.shape[-1])
