"""Device preprocessing of raw frames.

Counterpart of ``acoustic_image_generation_tpu/data/preprocess.py``:

- acoustic: per-frame min-max over (H, W, C);
- MFCC: the frontend (``ops.mfcc_kernel.mfcc``: the fused CUDA kernel on
  the card, its plain version on the CPU), then per-frame min-max over the
  12 coefficients; skipped (``mfcc=False``) for a task that does not read
  it, where JAX's jitted step drops it as dead code;
- video: BGR channel flip, then /255;
- action and location labels, one per frame, as int32;
- the Butterworth "filtered" branch (``compute_filtered``), which feeds the
  correspondence augmentation: the 125 Hz low-pass of every frame
  (``ops.sosfilt.filtfilt``: the CUDA kernel on the card, its plain version
  on the CPU), its MFCC, min-max normalized. When the MFCC of both the raw
  and the filtered audio is needed, one ``mfcc`` launch computes both;
- the correspondence augmentations, which double a batch with
  non-corresponding examples labelled 0: the silence map
  (``correspondence_augment``), the zeroed video (``..._no_video``) and
  the shuffled pairs of the music data (``correspondence_shuffle``).

A task that reads no MFCC or no video gets ``None`` in that field (JAX's
jitted step drops the work as dead code).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from acoustic_image_generation_tpu_torch.ops.mfcc_kernel import mfcc
from acoustic_image_generation_tpu_torch.ops.sosfilt import filtfilt


class Batch(NamedTuple):
    """Model-ready frames (leading axis = frames)."""

    audio: torch.Tensor  # (N, 1024) float32 waveform
    mfcc: torch.Tensor | None  # (N, 12) in [0, 1]; None when skipped
    video: torch.Tensor  # (N, 224, 298, 3) in [0, 1]
    acoustic: torch.Tensor | None = None  # (N, 36, 48, C) in [0, 1]
    action: torch.Tensor | None = None  # (N,) int32
    location: torch.Tensor | None = None  # (N,) int32
    filtered_mfcc: torch.Tensor | None = None  # (N, 12) in [0, 1], the low-passed audio's
    correspondence: torch.Tensor | None = None  # (N, 2) one-hot, set by the augmentations


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
    video_raw: torch.Tensor | None,  # (N, 224, 298, 3) uint8
    acoustic_raw: torch.Tensor | None = None,  # (N, 36, 48, C)
    action: torch.Tensor | None = None,  # (N,) int
    location: torch.Tensor | None = None,  # (N,) int
    *,
    compute_filtered: bool = False,
    compute_mfcc: bool = True,
) -> Batch:
    """Raw decoded frames -> model-ready batch. ``compute_filtered`` runs
    the low-pass branch into ``filtered_mfcc``."""
    wav = audio_raw.to(torch.float32)
    label = lambda t: None if t is None else t.to(torch.int32)
    coeffs = filtered = None
    if compute_filtered:
        low = filtfilt(wav.contiguous())
        if compute_mfcc:
            both = mfcc(torch.cat([wav, low]))
            coeffs, filtered = both[: wav.shape[0]], both[wav.shape[0]:]
        else:
            filtered = mfcc(low)
        filtered = normalize_mfcc(filtered)
    elif compute_mfcc:
        coeffs = mfcc(wav.contiguous())
    return Batch(
        audio=wav,
        mfcc=None if coeffs is None else normalize_mfcc(coeffs),
        video=None if video_raw is None else normalize_video(video_raw),
        acoustic=None if acoustic_raw is None else normalize_acoustic(acoustic_raw),
        action=label(action),
        location=label(location),
        filtered_mfcc=filtered,
    )


def tile_mfccmap(mfcc: torch.Tensor, h: int = 36, w: int = 48) -> torch.Tensor:
    """(N,12) -> (N,36,48,12) constant spatial map (a broadcast view)."""
    return mfcc[:, None, None, :].expand(mfcc.shape[0], h, w, mfcc.shape[-1])


def _cat(a: torch.Tensor | None, b: torch.Tensor | None) -> torch.Tensor | None:
    return None if a is None or b is None else torch.cat([a, b])


def _onehot(labels: torch.Tensor) -> torch.Tensor:
    """(N,) 0/1 -> (N, 2) float32 one-hot."""
    return torch.eye(2, dtype=torch.float32, device=labels.device)[labels.long()]


def _halves(n: int, device) -> torch.Tensor:
    return torch.cat([torch.ones(n, dtype=torch.int32, device=device),
                      torch.zeros(n, dtype=torch.int32, device=device)])


def correspondence_augment(batch: Batch) -> Batch:
    """Double the batch with non-corresponding examples: the second half's
    acoustic image is the tiled MFCC of the low-passed audio ("silence");
    the first half is labelled 1, the second 0."""
    n = batch.audio.shape[0]
    fake = tile_mfccmap(batch.filtered_mfcc)
    return Batch(
        audio=torch.cat([batch.audio, batch.audio]),
        mfcc=_cat(batch.mfcc, batch.filtered_mfcc),
        video=_cat(batch.video, batch.video),
        acoustic=torch.cat([batch.acoustic, fake]),
        action=_cat(batch.action, batch.action),
        location=_cat(batch.location, batch.location),
        filtered_mfcc=torch.cat([batch.filtered_mfcc, batch.filtered_mfcc]),
        correspondence=_onehot(_halves(n, batch.audio.device)),
    )


def correspondence_augment_no_video(batch: Batch) -> Batch:
    """The variant that keeps the real acoustic images and zeroes the video
    frames of the second half (labelled 0)."""
    n = batch.audio.shape[0]
    return Batch(
        audio=torch.cat([batch.audio, batch.audio]),
        mfcc=_cat(batch.mfcc, batch.mfcc),
        video=None if batch.video is None else torch.cat([batch.video, torch.zeros_like(batch.video)]),
        acoustic=torch.cat([batch.acoustic, batch.acoustic]),
        action=_cat(batch.action, batch.action),
        location=_cat(batch.location, batch.location),
        filtered_mfcc=_cat(batch.filtered_mfcc, batch.filtered_mfcc),
        correspondence=_onehot(_halves(n, batch.audio.device)),
    )


def shuffle_permutations(clips: int, generator: torch.Generator, *, valid_clips: int | None = None,
                         final_shuffle: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The two permutations of ``correspondence_shuffle``, drawn from
    ``generator`` (on the CPU): the partner of each clip, and the order of
    the doubled batch (None without ``final_shuffle``). With
    ``valid_clips`` (a padded eval batch) only the first ``valid_clips``
    clips are permuted among themselves, by sorting uniform ranks, and the
    padding maps to itself."""
    if valid_clips is None:
        clip_perm = torch.randperm(clips, generator=generator)
    else:
        r = torch.rand(clips, generator=generator)
        idx = torch.arange(clips)
        clip_perm = torch.argsort(torch.where(idx < valid_clips, r, 2.0 + idx.float()))
    final = torch.randperm(2 * clips, generator=generator) if final_shuffle else None
    return clip_perm, final


def correspondence_shuffle(batch: Batch, clip_perm: torch.Tensor, final_perm: torch.Tensor | None = None,
                           *, frames: int = 1) -> Batch:
    """Shuffled-pair correspondence (the music data): double the batch; the
    first half keeps its aligned (audio, video) pairs, labelled 1; the
    second pairs each clip's video with clip ``clip_perm[i]``'s audio,
    acoustic image and MFCCs, labelled 1 only when the two share action
    and location (its ``action``/``location`` are the audio side's). Then
    the doubled batch is reordered by ``final_perm`` (clips of ``frames``
    rows, kept contiguous), when given. The permutations come from
    ``shuffle_permutations`` (the tests hand in JAX's)."""
    n = batch.audio.shape[0]
    if n % frames:
        raise ValueError(f"{n} rows are not clips of {frames} frames")
    dev = batch.audio.device
    steps = torch.arange(frames, device=dev)

    def expand(clip_order):
        return (clip_order.to(dev).long()[:, None] * frames + steps[None, :]).reshape(-1)

    perm = expand(clip_perm)
    take = lambda t: None if t is None else t[perm]
    action2, location2 = batch.action[perm], batch.location[perm]
    match = ((batch.action == action2) & (batch.location == location2)).to(torch.int32)
    labels = torch.cat([torch.ones(n, dtype=torch.int32, device=dev), match])
    doubled = Batch(
        audio=torch.cat([batch.audio, batch.audio[perm]]),
        mfcc=_cat(batch.mfcc, take(batch.mfcc)),
        video=_cat(batch.video, batch.video),
        acoustic=torch.cat([batch.acoustic, batch.acoustic[perm]]),
        action=torch.cat([batch.action, action2]),
        location=torch.cat([batch.location, location2]),
        filtered_mfcc=_cat(batch.filtered_mfcc, take(batch.filtered_mfcc)),
        correspondence=_onehot(labels),
    )
    if final_perm is None:
        return doubled
    order = expand(final_perm)
    return Batch(*[None if x is None else x[order] for x in doubled])
