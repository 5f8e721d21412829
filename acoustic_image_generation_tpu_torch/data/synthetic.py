"""Synthetic dataset shard writer.

Counterpart of ``acoustic_image_generation_tpu/data/synthetic.py``: writes
ACIVW-shaped datasets, per-second GZIP TFRecord files of SequenceExamples
with the dualcam feature schema, plus the list files the loader reads, so
tests and ``chip_smoke.py`` need no dataset. The same seed writes the same
arrays as the JAX package's writer.
"""

from __future__ import annotations

import os

import numpy as np

from acoustic_image_generation_tpu_torch.data import proto, tfrecord
from acoustic_image_generation_tpu_torch.data.schema import (
    ACOUSTIC_H,
    ACOUSTIC_W,
    FRAMES_PER_SECOND,
    NUM_SAMPLES,
    VIDEO_H,
    VIDEO_W,
)


def make_sequence_example(
    *,
    acoustic: np.ndarray,  # (12, 36, 48, C) float32
    audio: np.ndarray,  # (12, 1024) int32
    video: np.ndarray,  # (12, 224, 298, 3) uint8
    action: int,
    location: int,
) -> proto.SequenceExample:
    ex = proto.SequenceExample()
    ex.context["classes"] = proto.int64_feature(action)
    ex.context["location"] = proto.int64_feature(location)
    ex.context["audio_image/height"] = proto.int64_feature(acoustic.shape[1])
    ex.context["audio_image/width"] = proto.int64_feature(acoustic.shape[2])
    ex.context["audio_image/depth"] = proto.int64_feature(acoustic.shape[3])
    ex.context["audio_data/mics"] = proto.int64_feature(1)
    ex.context["audio_data/samples"] = proto.int64_feature(audio.shape[1])
    ex.context["video/height"] = proto.int64_feature(video.shape[1])
    ex.context["video/width"] = proto.int64_feature(video.shape[2])
    ex.context["video/depth"] = proto.int64_feature(video.shape[3])
    ex.feature_lists["audio/image"] = [
        proto.bytes_feature(np.ascontiguousarray(f, dtype=np.float32).tobytes())
        for f in acoustic
    ]
    ex.feature_lists["audio/data"] = [
        proto.bytes_feature(np.ascontiguousarray(f, dtype=np.int32).tobytes())
        for f in audio
    ]
    ex.feature_lists["video/image"] = [
        proto.bytes_feature(np.ascontiguousarray(f, dtype=np.uint8).tobytes())
        for f in video
    ]
    return ex


def make_second_example(
    *,
    classes: int,
    location: int,
    audio: np.ndarray | None = None,  # (12, 1024) int32
    video: np.ndarray | None = None,  # (12, 224, 298, 3) uint8
    acoustic: np.ndarray | None = None,  # (12, 36, 48, C) float32
    boxes: dict | None = None,  # {xmin,xmax,ymin,ymax,typescene}: (12, 3) int32
    classnumber: int | None = None,
    event: int | None = None,
) -> bytes:
    """One second of synchronized data -> serialized SequenceExample, any
    modality optional (the counterpart of the JAX package's
    ``data/convert.py::make_second_example``)."""
    ex = proto.SequenceExample()
    ex.context["classes"] = proto.int64_feature(classes)
    ex.context["location"] = proto.int64_feature(location)
    if audio is not None:
        ex.context["audio_data/mics"] = proto.int64_feature(1)
        ex.context["audio_data/samples"] = proto.int64_feature(audio.shape[1])
        ex.feature_lists["audio/data"] = [
            proto.bytes_feature(np.ascontiguousarray(f, np.int32).tobytes()) for f in audio
        ]
    if video is not None:
        ex.context["video/height"] = proto.int64_feature(video.shape[1])
        ex.context["video/width"] = proto.int64_feature(video.shape[2])
        ex.context["video/depth"] = proto.int64_feature(video.shape[3])
        ex.feature_lists["video/image"] = [
            proto.bytes_feature(np.ascontiguousarray(f, np.uint8).tobytes()) for f in video
        ]
    if acoustic is not None:
        ex.context["audio_image/height"] = proto.int64_feature(acoustic.shape[1])
        ex.context["audio_image/width"] = proto.int64_feature(acoustic.shape[2])
        ex.context["audio_image/depth"] = proto.int64_feature(acoustic.shape[3])
        ex.feature_lists["audio/image"] = [
            proto.bytes_feature(np.ascontiguousarray(f, np.float32).tobytes()) for f in acoustic
        ]
    if boxes is not None:  # scaled int32 box features
        for key, arr in boxes.items():
            ex.feature_lists[key] = [
                proto.bytes_feature(np.ascontiguousarray(f, np.int32).tobytes()) for f in arr
            ]
    if classnumber is not None:
        ex.context["classnumber"] = proto.int64_feature(classnumber)
    if event is not None:
        ex.context["event"] = proto.int64_feature(event)
    return ex.encode()


def write_synthetic_dataset(
    out_dir: str,
    *,
    num_classes: int = 2,
    videos_per_class: int = 1,
    seconds_per_video: int = 4,
    num_channels: int = 12,
    seed: int = 0,
    video_hw: tuple[int, int] = (VIDEO_H, VIDEO_W),
) -> dict[str, str]:
    """Write a tiny ACIVW-shaped dataset. Returns {split: list_file_path}.

    Directory layout mirrors the converter:
    ``{out}/class_{c}/data_{v:03d}/Data_{s:03d}.tfrecord``.

    The data is *learnable* end to end, mirroring how the real sensor
    couples modalities: each second has a sound source at a random grid
    position — the acoustic image is a Gaussian energy blob there (plus
    noise), the video frame shows a bright marker at the corresponding
    pixel location, and the audio is a class-dependent tone. A generator
    conditioned on (video, mfcc) can therefore genuinely learn to localize,
    making the IoU/AUC evaluation meaningful on synthetic shards.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ACOUSTIC_H, 0:ACOUSTIC_W].astype(np.float32)
    all_files: list[str] = []
    for c in range(num_classes):
        for v in range(videos_per_class):
            # Globally unique data_NNN dirs: the loaders group consecutive
            # list lines by path[-2], so repeating dir names across classes
            # would merge videos.
            loc = c * videos_per_class + v + 1
            data_dir = os.path.join(out_dir, f"class_{c}", f"data_{loc:03d}")
            os.makedirs(data_dir, exist_ok=True)
            # a class-dependent tone so models can actually learn
            t = np.arange(seconds_per_video * FRAMES_PER_SECOND * NUM_SAMPLES)
            freq = 200.0 * (c + 1)
            wave = (
                3000 * np.sin(2 * np.pi * freq * t / 12288.0)
                + rng.normal(0, 100, t.shape)
            ).astype(np.int32)
            for s in range(seconds_per_video):
                # sound source position for this second
                cy = rng.uniform(6, ACOUSTIC_H - 6)
                cx = rng.uniform(6, ACOUSTIC_W - 6)
                blob = np.exp(-(((yy - cy) ** 2) + ((xx - cx) ** 2)) / (2 * 4.0**2))
                # class-DEPENDENT channel profile (survives the loaders'
                # per-frame min-max normalization, so classifiers can
                # learn). Strongly separated half-band profiles: the sin
                # profiles used earlier made the class signal so marginal
                # that the generator's profile-learning phase onset was
                # luck-of-the-seed (hundreds of epochs of variance).
                ch = np.arange(num_channels)
                band = (ch < num_channels // 2) if c % 2 == 0 else (
                    ch >= num_channels // 2
                )
                profile = np.where(band, 1.0, 0.3)
                per_ch = (profile * (0.95 + 0.1 * rng.random(num_channels))).astype(
                    np.float32
                )
                acoustic = (
                    blob[None, :, :, None] * per_ch[None, None, None, :]
                    + 0.05 * rng.random(
                        (FRAMES_PER_SECOND, ACOUSTIC_H, ACOUSTIC_W, num_channels)
                    )
                ).astype(np.float32) * (c + 1)
                # store in the dualcam sensor convention: the loaders flip
                # acoustic images l/r + u/d at parse to align them with the
                # video, so shards carry the mirrored image.
                acoustic = np.ascontiguousarray(acoustic[:, ::-1, ::-1, :])
                sl = slice(
                    s * FRAMES_PER_SECOND * NUM_SAMPLES,
                    (s + 1) * FRAMES_PER_SECOND * NUM_SAMPLES,
                )
                audio = wave[sl].reshape(FRAMES_PER_SECOND, NUM_SAMPLES)
                # video: dark noise background + bright marker at the
                # source position (acoustic lattice scaled to pixels); the
                # marker COLOR is class-dependent so the video modality is
                # class-informative too (like a real source's appearance),
                # which embedding recipes need for video-latent kNN
                video = rng.integers(
                    0, 64, (FRAMES_PER_SECOND, *video_hw, 3), dtype=np.uint8
                )
                py = int(cy / ACOUSTIC_H * video_hw[0])
                px = int(cx / ACOUSTIC_W * video_hw[1])
                y0, y1 = max(py - 10, 0), min(py + 10, video_hw[0])
                x0, x1 = max(px - 10, 0), min(px + 10, video_hw[1])
                color = np.full(3, 96, np.uint8)
                color[c % 3] = 255
                video[:, y0:y1, x0:x1, :] = color
                ex = make_sequence_example(
                    acoustic=acoustic,
                    audio=audio,
                    video=video,
                    action=c,
                    location=loc,
                )
                path = os.path.join(data_dir, f"Data_{s + 1:03d}.tfrecord")
                tfrecord.write_records(path, [ex.encode()])
                all_files.append(path)

    lists = {}
    for split in ("training", "validation", "testing"):
        list_path = os.path.join(out_dir, f"lists/{split}.txt")
        os.makedirs(os.path.dirname(list_path), exist_ok=True)
        with open(list_path, "w") as f:
            f.write("\n".join(all_files) + "\n")
        lists[split] = list_path
    return lists


def write_flickr_dataset(
    out_dir: str,
    *,
    num_videos: int = 2,
    seconds_per_video: int = 2,
    seed: int = 0,
) -> dict[str, str]:
    """Flickr-SoundNet-shaped shards: zero acoustic images, audio + video,
    up to 3 scaled bounding boxes per frame stored as int32 raw-byte
    sequence features."""
    rng = np.random.default_rng(seed)
    all_files: list[str] = []
    for v in range(num_videos):
        data_dir = os.path.join(out_dir, "flickr", f"data_{v + 1:03d}")
        os.makedirs(data_dir, exist_ok=True)
        t = np.arange(seconds_per_video * FRAMES_PER_SECOND * NUM_SAMPLES)
        wave = (
            3000 * np.sin(2 * np.pi * 200.0 * t / 12288.0)
            + rng.normal(0, 100, t.shape)
        ).astype(np.int32)
        for s in range(seconds_per_video):
            sl = slice(s * FRAMES_PER_SECOND * NUM_SAMPLES,
                       (s + 1) * FRAMES_PER_SECOND * NUM_SAMPLES)
            audio = wave[sl].reshape(FRAMES_PER_SECOND, NUM_SAMPLES)
            # the annotated box surrounds an actual sound-source marker
            # (class-0 colored, like the ACIVW-shaped synthetic set), so a
            # trained generator's energy should land inside it — making
            # the weighted-box IoU sweep a meaningful localization eval
            video = rng.integers(
                0, 64, (FRAMES_PER_SECOND, VIDEO_H, VIDEO_W, 3), dtype=np.uint8
            )
            py = int(rng.integers(40, VIDEO_H - 40))
            px = int(rng.integers(40, VIDEO_W - 40))
            color = np.array([255, 96, 96], np.uint8)
            video[:, py - 10:py + 10, px - 10:px + 10, :] = color
            # one real box + two absent slots (xmax == 0 marks absence)
            boxes = {k: np.zeros((FRAMES_PER_SECOND, 3), np.int32)
                     for k in ("xmin", "xmax", "ymin", "ymax", "typescene")}
            # object-scale annotation (real Flickr boxes cover the
            # source object, not just its center): sized to the energy
            # blob's above-mean footprint
            boxes["xmin"][:, 0] = max(px - 45, 0)
            boxes["xmax"][:, 0] = min(px + 45, VIDEO_W - 1)
            boxes["ymin"][:, 0] = max(py - 45, 0)
            boxes["ymax"][:, 0] = min(py + 45, VIDEO_H - 1)
            payload = make_second_example(
                classes=0, location=v + 1,
                audio=audio, video=video,
                acoustic=np.zeros((FRAMES_PER_SECOND, ACOUSTIC_H, ACOUSTIC_W, 12), np.float32),
                boxes=boxes,
            )
            path = os.path.join(data_dir, f"Data_{s + 1:03d}.tfrecord")
            tfrecord.write_records(path, [payload])
            all_files.append(path)
    list_path = os.path.join(out_dir, "lists/flickr_testing.txt")
    os.makedirs(os.path.dirname(list_path), exist_ok=True)
    with open(list_path, "w") as f:
        f.write("\n".join(all_files) + "\n")
    return {"testing": list_path}
