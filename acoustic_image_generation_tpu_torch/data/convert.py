"""Raw captures -> TFRecord shards, on the host, in numpy.

Counterpart of ``acoustic_image_generation_tpu/data/convert.py``, with the
same functions, arguments and files:

- video frames: aspect-preserving bilinear resize to smallest side 224,
  then the central 224x298 crop, stored as raw uint8 bytes;
- audio: the synchronized wav cut into 12 x 1024-sample chunks a second,
  stored as raw int32 bytes;
- layout ``{out}/class_{c}/data_{v:03d}/Data_{s:03d}.tfrecord``, one GZIP
  ``SequenceExample`` a second, through ``data/tfrecord.py`` and
  ``data/proto.py``;
- the other datasets' context features: FlickrSoundNet boxes (int32
  per-frame sequence features), ``classnumber`` (the collected set),
  ``event`` (AVE).

Nothing here touches a GPU. scipy reads and writes wav files and resamples;
Pillow reads and resizes images. Both are imported where they are used. A
path that reads or resizes an image without Pillow raises ``ImportError``
(``require_pil``): no other resize stands in for Pillow's, since its bytes
are the shards' bytes. Audio-only conversion (``modalities=(1,)``,
``--modalities 1``) needs no Pillow.
"""

from __future__ import annotations

import os

import numpy as np

from acoustic_image_generation_tpu_torch.data import proto, tfrecord

FRAMES_PER_SECOND = 12
NUM_SAMPLES = 1024
VIDEO_H, VIDEO_W = 224, 298
NUM_MICS = 128

# 2-object collected set: file number -> class id
COLLECTED_CLASSNUMBERS = (9, 9, 9, 9, 9, 9, 2, 9, 9, 4, 6, 7, 6, 1, 1, 8, 8,
                          2, 2, 0, 2, 3, 5)


def require_pil():
    """``PIL.Image``, or ``ImportError`` naming Pillow and the audio-only
    conversion that works without it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or resizing video frames needs Pillow (the PIL package), which this Python lacks; "
            "convert audio only with --modalities 1 (modalities=(1,)), which needs no Pillow"
        ) from e
    return Image


def aspect_preserving_resize(image: np.ndarray, smallest_side: int = 224) -> np.ndarray:
    """Bilinear resize so that min(h, w) == smallest_side."""
    Image = require_pil()
    h, w = image.shape[:2]
    scale = smallest_side / min(h, w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    return np.asarray(Image.fromarray(image).resize((new_w, new_h), Image.BILINEAR))


def central_crop(image: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    h, w = image.shape[:2]
    oh = (h - crop_h) // 2
    ow = (w - crop_w) // 2
    return image[oh: oh + crop_h, ow: ow + crop_w, :]


def prepare_video_frame(image: np.ndarray) -> np.ndarray:
    """Raw frame -> (224, 298, 3) uint8."""
    image = aspect_preserving_resize(image, 224)
    image = central_crop(image, VIDEO_H, VIDEO_W)
    assert image.shape == (VIDEO_H, VIDEO_W, 3), image.shape
    return np.ascontiguousarray(image, dtype=np.uint8)


def read_wav(path: str) -> np.ndarray:
    """Mono waveform as int32 samples (the first channel of a multichannel
    file)."""
    from scipy.io import wavfile

    _, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    return data.astype(np.int32)


def read_dc_frame(path: str, *, num_mics: int = NUM_MICS, num_samples: int = 1024) -> np.ndarray:
    """One raw dualcam audio capture (``A_{N:06d}.dc``): int32 (mics,
    samples), stored in Fortran order."""
    data = np.fromfile(path, np.int32)
    return data.reshape((num_mics, num_samples), order="F")


def mux_mic_wav(data_dir: str, out_path: str, mic_id: int, *, audio_subdir: str = "audio") -> str:
    """One microphone's track from a capture's ``.dc`` files, written as a
    wav: files 1-indexed, the waveform peak-normalized to [-1, 1] as f32
    samples, the rate written as 12 * 1000 = 12000 Hz (not the true 12288),
    as the JAX package writes it."""
    from scipy.io import wavfile

    audio_dir = os.path.join(data_dir, audio_subdir)
    num_files = len([n for n in os.listdir(audio_dir) if n.endswith(".dc")])
    tracks = [read_dc_frame(os.path.join(audio_dir, f"A_{h + 1:06d}.dc"))[mic_id] for h in range(num_files)]
    flat = np.concatenate(tracks).astype(np.float32)
    peak = abs(max(flat.min(), flat.max(), key=abs))
    flat = flat / peak if peak else flat
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    wavfile.write(out_path, FRAMES_PER_SECOND * 1000, flat)
    return out_path


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
    """One second of synchronized data -> a serialized ``SequenceExample``
    in the loaders' schema (``data/schema.py``)."""
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
    if boxes is not None:
        for key, arr in boxes.items():
            ex.feature_lists[key] = [proto.bytes_feature(np.ascontiguousarray(f, np.int32).tobytes()) for f in arr]
    if classnumber is not None:
        ex.context["classnumber"] = proto.int64_feature(classnumber)
    if event is not None:
        ex.context["event"] = proto.int64_feature(event)
    return ex.encode()


def convert_capture_dir(
    raw_dir: str,
    out_dir: str,
    *,
    classes: int,
    location: int,
    modalities: tuple[int, ...] = (1, 2),
    wav_name: str = "audio/output_audio2.wav",
    frame_pattern: str = "video/I_{:06d}.bmp",
    video_time: int | None = None,
    event_window: tuple[int, int] | None = None,
) -> list[str]:
    """One capture directory (``class_X/data_YYY/{video/*.bmp,
    audio/output_audio2.wav, video_time.txt}``) -> per-second shards.
    Returns the written paths. ``event_window=(start, end)`` adds AVE's
    ``event`` context label: 1 for start <= second <= end, else 0. Video
    (modality 2) needs Pillow; audio (modality 1) does not."""
    if video_time is None:
        with open(os.path.join(raw_dir, "video_time.txt")) as f:
            video_time = int(f.readline().split(":")[1].strip())
    include_audio = 1 in modalities
    include_video = 2 in modalities
    Image = require_pil() if include_video else None

    wav = read_wav(os.path.join(raw_dir, wav_name)) if include_audio else None
    out_data_dir = os.path.join(out_dir, f"class_{classes}", f"data_{location:03d}")
    os.makedirs(out_data_dir, exist_ok=True)

    written = []
    for sec in range(video_time):
        audio = video = None
        if include_audio:
            start = sec * FRAMES_PER_SECOND * NUM_SAMPLES
            audio = wav[start: start + FRAMES_PER_SECOND * NUM_SAMPLES].reshape(FRAMES_PER_SECOND, NUM_SAMPLES)
        if include_video:
            frames = []
            for i in range(FRAMES_PER_SECOND):
                idx = sec * FRAMES_PER_SECOND + i + 1
                img = np.asarray(Image.open(os.path.join(raw_dir, frame_pattern.format(idx))))
                frames.append(prepare_video_frame(img))
            video = np.stack(frames)
        event = None
        if event_window is not None:
            event = int(event_window[0] <= sec <= event_window[1])
        payload = make_second_example(classes=classes, location=location, audio=audio, video=video, event=event)
        path = os.path.join(out_data_dir, f"Data_{sec + 1:03d}.tfrecord")
        tfrecord.write_records(path, [payload])
        written.append(path)
    return written


def resample_to_12288(data: np.ndarray, fs: int) -> np.ndarray:
    """A waveform at the dualcam rate (12 x 1024 = 12288 Hz), int32, by
    ``scipy.signal.resample_poly`` over the rates' GCD. IEEE-float samples
    in [-1, 1] are scaled to the int16 range first."""
    from math import gcd

    from scipy.signal import resample_poly

    if np.issubdtype(data.dtype, np.floating):
        data = np.clip(data, -1.0, 1.0) * 32767.0
    target = FRAMES_PER_SECOND * NUM_SAMPLES
    if fs == target:
        return np.round(data).astype(np.int32) if data.dtype.kind == "f" else data.astype(np.int32)
    g = gcd(target, fs)
    out = resample_poly(data.astype(np.float64), target // g, fs // g)
    return np.round(out).astype(np.int32)


def _read_image(path: str, *, size: tuple[int, int] | None = None) -> np.ndarray:
    """An image as BGR uint8 (the byte order cv2 stores; the loader's
    ``normalize_video`` flips it back). ``size=(w, h)``: a direct bicubic
    resize."""
    Image = require_pil()
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BICUBIC)
    rgb = np.asarray(img, dtype=np.uint8)
    return rgb[..., ::-1]


def parse_flickr_xml(xml_path: str, image_name: str) -> dict:
    """A FlickrSoundNet annotation XML -> up to 3 boxes scaled onto the
    224x298 frame from a source geometry fixed at 256x256 (x by 298/256, y
    by 224/256); ``type == 'object'`` is typescene 1, anything else 0.
    Returns (3,) int32 arrays xmin/xmax/ymin/ymax/typescene, unused slots
    zero."""
    import xml.etree.ElementTree as ET

    horizontal_scale = VIDEO_W / 256
    vertical_scale = VIDEO_H / 256
    root = ET.parse(xml_path).getroot()
    if root.find("file_name").text != image_name:
        raise ValueError(f"{xml_path} annotates {root.find('file_name').text}, not {image_name}")
    out = {k: np.zeros(3, np.int32) for k in ("xmin", "xmax", "ymin", "ymax", "typescene")}
    for num_p, member in enumerate(root.findall("person")[:3]):
        bndbox = member.find("bbox")
        out["typescene"][num_p] = 1 if bndbox.find("type").text == "object" else 0
        out["xmin"][num_p] = int(round(int(bndbox.find("xmin").text) * horizontal_scale))
        out["xmax"][num_p] = int(round(int(bndbox.find("xmax").text) * horizontal_scale))
        out["ymin"][num_p] = int(round(int(bndbox.find("ymin").text) * vertical_scale))
        out["ymax"][num_p] = int(round(int(bndbox.find("ymax").text) * vertical_scale))
    return out


def _one_second_audio(wav_12288: np.ndarray) -> np.ndarray:
    """The first second of a 12288 Hz waveform as (12, 1024) int32,
    zero-padded when shorter."""
    need = FRAMES_PER_SECOND * NUM_SAMPLES
    buf = np.zeros(need, np.int32)
    n = min(len(wav_12288), need)
    buf[:n] = wav_12288[:n]
    return buf.reshape(FRAMES_PER_SECOND, NUM_SAMPLES)


def _wav_second(path: str) -> np.ndarray:
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    return _one_second_audio(resample_to_12288(data, fs))


def _write_list(out_dir: str, written: list[str]) -> str:
    list_path = os.path.join(out_dir, "testing.txt")
    with open(list_path, "w") as f:
        for p in written:
            f.write(p + "\n")
    return list_path


def convert_flickr(root_raw_dir: str, out_dir: str, *, modalities: tuple[int, ...] = (1, 2)) -> str:
    """FlickrSoundNet raw -> shards and a test list. For every jpg under
    ``{root}/Dataset/Data/*/`` named in ``{root}/test_list.txt``: its wav
    resampled to 12288 Hz (the first second), the jpg resized to 298x224
    (bicubic) and tiled over the second's 12 frames, and its XML boxes per
    frame. Returns the list file, ``{out}/testing.txt``."""
    import glob as _glob

    with open(os.path.join(root_raw_dir, "test_list.txt")) as f:
        test_list = {line.strip() for line in f if line.strip()}
    include_audio = 1 in modalities
    include_video = 2 in modalities
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for data_dir in sorted(_glob.glob(os.path.join(root_raw_dir, "Dataset", "Data", "*/"))):
        for image in sorted(os.listdir(data_dir)):
            if not image.endswith(".jpg") or image not in test_list:
                continue
            num = image[: -len(".jpg")]
            boxes3 = parse_flickr_xml(os.path.join(root_raw_dir, "Dataset", "Annotations", f"{num}.xml"), image)
            boxes = {k: np.tile(v, (FRAMES_PER_SECOND, 1)) for k, v in boxes3.items()}
            audio = _wav_second(os.path.join(data_dir, f"{num}.wav")) if include_audio else None
            video = None
            if include_video:
                frame = _read_image(os.path.join(data_dir, image), size=(VIDEO_W, VIDEO_H))
                video = np.tile(frame[None], (FRAMES_PER_SECOND, 1, 1, 1))
            payload = make_second_example(classes=0, location=0, audio=audio, video=video, boxes=boxes)
            path = os.path.join(out_dir, f"{num}.tfrecord")
            tfrecord.write_records(path, [payload])
            written.append(path)
    return _write_list(out_dir, written)


def convert_ave(root_raw_dir: str, out_dir: str, *, modalities: tuple[int, ...] = (1, 2)) -> list[str]:
    """AVE captures -> per-second shards with the ``event`` label. Walks
    ``{root}/*/*/video/``; the class comes from the ``class_N`` path
    element, the location from ``data_NNN``; ``video_time.txt`` gives the
    clip's length and ``seconds.txt`` the ``start:end`` window of the
    event."""
    import glob as _glob
    import re

    written = []
    for video_dir in sorted(_glob.glob(os.path.join(root_raw_dir, "*", "*", "video/"))):
        capture = os.path.dirname(os.path.dirname(video_dir))
        parts = capture.split(os.sep)
        classes = int(next(p for p in parts if re.match(r"class_", p)).split("_")[1])
        location = int(next(p for p in parts if re.match(r"data_", p)).split("_")[1])
        with open(os.path.join(capture, "seconds.txt")) as f:
            t = f.read().strip()
            start, end = int(t.split(":")[0]), int(t.split(":")[1])
        with open(os.path.join(capture, "video_time.txt")) as f:
            video_time = int(f.readline().split(":")[1].strip())
        written.extend(convert_capture_dir(capture, out_dir, classes=classes, location=location,
                                           modalities=modalities, video_time=video_time,
                                           event_window=(start, end)))
    return written


def convert_collected(root_raw_dir: str, out_dir: str, *, modalities: tuple[int, ...] = (1, 2)) -> str:
    """The 2-object collected set -> shards with the ``classnumber``
    context feature: a flat directory of ``N.png`` + ``N.wav`` pairs named
    in ``{root}/test_list.txt``; classnumber = COLLECTED_CLASSNUMBERS[N-1].
    The same one-second layout as ``convert_flickr``. Returns the list
    file."""
    with open(os.path.join(root_raw_dir, "test_list.txt")) as f:
        test_list = {line.strip() for line in f if line.strip()}
    include_audio = 1 in modalities
    include_video = 2 in modalities
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for image in sorted(os.listdir(root_raw_dir)):
        if not image.endswith(".png") or image not in test_list:
            continue
        num = int(image[: -len(".png")])
        audio = _wav_second(os.path.join(root_raw_dir, f"{num}.wav")) if include_audio else None
        video = None
        if include_video:
            frame = _read_image(os.path.join(root_raw_dir, image), size=(VIDEO_W, VIDEO_H))
            video = np.tile(frame[None], (FRAMES_PER_SECOND, 1, 1, 1))
        payload = make_second_example(classes=0, location=0, audio=audio, video=video,
                                      classnumber=int(COLLECTED_CLASSNUMBERS[num - 1]))
        path = os.path.join(out_dir, f"{num}.tfrecord")
        tfrecord.write_records(path, [payload])
        written.append(path)
    return _write_list(out_dir, written)


def write_list_files(out_dir: str, shard_paths: list[str], splits=(0.7, 0.15, 0.15)) -> dict:
    """Training, validation and testing list files under ``{out}/lists``,
    split by whole capture directory (not by second)."""
    by_dir: dict[str, list[str]] = {}
    for p in sorted(shard_paths):
        by_dir.setdefault(os.path.dirname(p), []).append(p)
    dirs = sorted(by_dir)
    n = len(dirs)
    n_train = max(int(n * splits[0]), 1)
    n_valid = max(int(n * splits[1]), 1) if n > 2 else 0
    groups = {
        "training": dirs[:n_train],
        "validation": dirs[n_train: n_train + n_valid],
        "testing": dirs[n_train + n_valid:],
    }
    lists = {}
    os.makedirs(os.path.join(out_dir, "lists"), exist_ok=True)
    for split, ds in groups.items():
        path = os.path.join(out_dir, "lists", f"{split}.txt")
        with open(path, "w") as f:
            for d in ds:
                for p in by_dir[d]:
                    f.write(p + "\n")
        lists[split] = path
    return lists


def reshard(list_file: str, out_dir: str, *, compression: str | None = None) -> str:
    """Rewrite a list's shards (uncompressed by default: gzip inflate
    dominates one core's decode) under ``out_dir``, keeping the last two
    directories of each path. Returns the new list file."""
    new_paths = []
    with open(list_file) as f:
        paths = [line.strip() for line in f if line.strip()]
    for path in paths:
        records = tfrecord.read_records(path)
        parts = path.rstrip("/").split("/")
        dest_dir = os.path.join(out_dir, parts[-3], parts[-2])
        os.makedirs(dest_dir, exist_ok=True)
        dest = os.path.join(dest_dir, parts[-1])
        tfrecord.write_records(dest, records, compression=compression)
        new_paths.append(dest)
    new_list = os.path.join(out_dir, os.path.basename(list_file))
    with open(new_list, "w") as f:
        f.write("\n".join(new_paths) + "\n")
    return new_list
