"""Dataset record schema: SequenceExample -> numpy arrays.

Counterpart of ``acoustic_image_generation_tpu/data/schema.py``. One
TFRecord file holds one SequenceExample covering one second (12 frames) of
synchronized acoustic image, raw audio and video; the context carries the
class, the location and the geometry of each modality. Flickr-SoundNet
shards add per-frame box features, the 2-object set a ``classnumber`` and
AVE an ``event`` id, which land in ``extras``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from acoustic_image_generation_tpu_torch.data.proto import SequenceExample

ACOUSTIC_H = 36
ACOUSTIC_W = 48
FRAMES_PER_SECOND = 12
NUM_SAMPLES = 1024
VIDEO_H = 224
VIDEO_W = 298


@dataclass
class DecodedRecord:
    """One second of decoded sensor data."""

    acoustic: np.ndarray | None  # (12, 36, 48, C) float32
    audio: np.ndarray | None  # (12, 1024) int32
    video: np.ndarray | None  # (12, 224, 298, 3) uint8
    action: int
    location: int
    extras: dict


def decode_record(
    payload: bytes,
    *,
    datakind: str = "outdoor",
    include_acoustic: bool = True,
    include_audio: bool = True,
    include_video: bool = True,
    flip_acoustic: bool | None = None,
    num_channels: int = 12,
) -> DecodedRecord:
    """Decode one serialized SequenceExample.

    ``flip_acoustic`` defaults to True for non-music kinds: the acoustic
    image is flipped left/right and up/down at parse time, to align it with
    the video (the music parser does not flip).
    """
    ex = SequenceExample.decode(payload)
    ctx = ex.context
    action = int(ctx["classes"].int64_list[0]) if "classes" in ctx else 0
    location = int(ctx["location"].int64_list[0]) if "location" in ctx else 0
    if flip_acoustic is None:
        flip_acoustic = datakind != "music"

    acoustic = None
    if include_acoustic and "audio/image" in ex.feature_lists:
        h = int(ctx["audio_image/height"].int64_list[0])
        w = int(ctx["audio_image/width"].int64_list[0])
        d = int(ctx["audio_image/depth"].int64_list[0])
        frames = [
            np.frombuffer(f.bytes_list[0], dtype=np.float32).reshape(h, w, d)
            for f in ex.feature_lists["audio/image"]
        ]
        acoustic = np.stack(frames)
        if flip_acoustic:
            # tf.image.flip_left_right + flip_up_down
            acoustic = acoustic[:, ::-1, ::-1, :].copy()

    audio = None
    if include_audio and "audio/data" in ex.feature_lists:
        samples = int(ctx["audio_data/samples"].int64_list[0])
        frames = [
            np.frombuffer(f.bytes_list[0], dtype=np.int32).reshape(-1, samples)
            for f in ex.feature_lists["audio/data"]
        ]
        audio = np.concatenate(frames).reshape(-1, samples)

    video = None
    if include_video and "video/image" in ex.feature_lists:
        h = int(ctx["video/height"].int64_list[0])
        w = int(ctx["video/width"].int64_list[0])
        d = int(ctx["video/depth"].int64_list[0])
        frames = [
            np.frombuffer(f.bytes_list[0], dtype=np.uint8).reshape(h, w, d)
            for f in ex.feature_lists["video/image"]
        ]
        video = np.stack(frames)

    extras = {}
    # Flickr-SoundNet bounding boxes: per-frame int32 raw-byte sequence
    # features, up to 3 boxes per frame.
    for key in ("xmin", "xmax", "ymin", "ymax", "typescene"):
        if key in ex.feature_lists:
            vals = [
                np.frombuffer(f.bytes_list[0], dtype=np.int32)
                for f in ex.feature_lists[key]
            ]
            extras[key] = np.stack(vals)
    # 2-object collected set class id
    if "classnumber" in ctx:
        extras["classnumber"] = int(ctx["classnumber"].int64_list[0])
    # AVE event label
    if "event" in ctx:
        extras["event"] = int(ctx["event"].int64_list[0])

    return DecodedRecord(acoustic, audio, video, action, location, extras)
