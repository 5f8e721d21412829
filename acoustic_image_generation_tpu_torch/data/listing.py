"""Dataset list tools, on the host.

Counterpart of ``acoustic_image_generation_tpu/data/listing.py``, with the
same functions and files. Fetching (youtube_dl) and ffmpeg extraction stay
outside, as printed commands:

- ``framecount``: per-capture ``video_time.txt`` (and a wav trimmed to it),
  per-class ``class_time.txt``, and per-capture ``testing_file.txt`` lists
  of shards or frames;
- ``vggsound_video_list``: the VGGSound csv filtered to the experiment's
  class subsets, written as the ``videolista.txt`` download list (a class
  name header, then YouTube URLs);
- ``ave_capture_layout``: the '&'-separated AVE csv as the
  ``class_{c}/data_{d:03d}/{video,audio}`` capture layout with
  ``seconds.txt`` event windows, at most 8 captures a class.

scipy (wav files) is imported where it is used.
"""

from __future__ import annotations

import csv as _csv
import glob
import os

import numpy as np

FRAMERATE = 12

# class-name filters and their ids
VGGSOUND_OUTDOOR = {
    "train wagon": 0, "motorboat": 1, "waterfall": 3, "razor": 5,
    "hair dryer": 6, "vacuum cleaner": 7, "car passing by": 9,
}
VGGSOUND_INDOOR = {
    "clapping": 0, "people finger snapping": 1,
    "male speech, man speaking": 2, "people whistling": 3, "clicking": 5,
    "typing on computer keyboard": 6, "hammering": 8, "ripping paper": 10,
    "plastic": 11,
}


def framecount(root_raw_dir: str, out_dir: str, *, tfrecord: bool = True,
               trim_wav: bool = False) -> dict:
    """framecount.py: walk ``class_*/data_*`` captures; write per-capture
    ``testing_file.txt`` (sorted shard or frame paths), ``video_time.txt``
    ("video seconds: N"), and per-class ``class_time.txt``. In raw mode
    (tfrecord=False) seconds = frames//12 clamped to the wav length;
    ``trim_wav`` rewrites the wav to exactly that many seconds
    (framecount.py:77-83). Returns {capture_dir: seconds}."""
    from scipy.io import wavfile

    seconds_by_dir: dict[str, int] = {}
    for class_dir in sorted(glob.glob(os.path.join(root_raw_dir, "class_*/"))):
        class_seconds = 0
        for data_dir in sorted(glob.glob(os.path.join(class_dir, "data_*/"))):
            data_dir = data_dir.rstrip("/")
            if tfrecord:
                files = sorted(glob.glob(os.path.join(data_dir, "*.tfrecord")))
                video_seconds = len(files)
            else:
                files = sorted(glob.glob(os.path.join(data_dir, "video", "*.bmp")))
                video_seconds = len(files) // FRAMERATE
                wav_path = os.path.join(data_dir, "audio", "output_audio2.wav")
                if video_seconds > 0 and os.path.exists(wav_path):
                    fs, data = wavfile.read(wav_path)
                    samples = len(data) // (FRAMERATE * 1024)
                    video_seconds = int(np.minimum(video_seconds, samples))
                    if trim_wav:
                        wavfile.write(
                            wav_path, FRAMERATE * 1024,
                            data[: video_seconds * FRAMERATE * 1024],
                        )
            save_dir = os.path.join(out_dir, *data_dir.split(os.sep)[-2:])
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "testing_file.txt"), "w") as f:
                for p in files:
                    f.write(p + "\n")
            with open(os.path.join(data_dir, "video_time.txt"), "w") as f:
                f.write(f"video seconds: {video_seconds}")
            seconds_by_dir[data_dir] = video_seconds
            class_seconds += video_seconds
        with open(os.path.join(class_dir, "class_time.txt"), "w") as f:
            f.write(f"class seconds: {class_seconds}")
    return seconds_by_dir


def vggsound_video_list(csv_path: str, out_path: str, *,
                        classes: dict[str, int] | None = None,
                        split: str = "test") -> list[str]:
    """readcsv.py / csvtxt.py: filter the VGGSound csv (columns ``url``,
    ``class``, ``set``, ...) to ``classes`` (substring match like
    pandas ``str.contains``) and the given split, writing the reference's
    ``videolista.txt`` format: the class name on its first occurrence,
    then one YouTube URL per video. Duration filtering (reference: skip
    videos >= 3 min via youtube_dl metadata) is left to the downloader.
    Returns the written lines."""
    classes = classes or VGGSOUND_OUTDOOR
    lines: list[str] = []
    last_class = None
    with open(csv_path, newline="") as f:
        for row in _csv.DictReader(f):
            cl = row["class"]
            if split not in row.get("set", split):
                continue
            if not any(key in cl for key in classes):
                continue
            if cl != last_class:
                lines.append(cl)
                last_class = cl
            lines.append(f"https://www.youtube.com/watch?v={row['url']}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines


def ave_capture_layout(csv_path: str, out_dir: str, *,
                       max_per_class: int = 8) -> dict:
    """readave.py: '&'-separated AVE csv (``VideoID``, ``StartTime``,
    ``EndTime``, ``Category``) -> ``class_{c}/data_{d:03d}/{video,audio}``
    capture directories with ``seconds.txt`` holding the "start:end"
    event window; at most ``max_per_class`` captures per class
    (readave.py:52-55 ``d > 7: continue``). Returns
    {capture_dir: (video_id, start, end)} — feed each video through the
    reference's ffmpeg commands (readave.py:57-62) to populate it."""
    out: dict[str, tuple] = {}
    class_ids: dict[str, int] = {}
    counters: dict[int, int] = {}
    with open(csv_path, newline="") as f:
        for row in _csv.DictReader(f, delimiter="&"):
            cl = row["Category"]
            if cl not in class_ids:
                class_ids[cl] = len(class_ids)
            c = class_ids[cl]
            d = counters.get(c, -1) + 1
            counters[c] = d
            if d >= max_per_class:
                continue
            cap = os.path.join(out_dir, f"class_{c}", f"data_{d:03d}")
            os.makedirs(os.path.join(cap, "video"), exist_ok=True)
            os.makedirs(os.path.join(cap, "audio"), exist_ok=True)
            with open(os.path.join(cap, "seconds.txt"), "w") as sf:
                sf.write(f"{row['StartTime']}:{row['EndTime']}\n")
            out[cap] = (row["VideoID"], row["StartTime"], row["EndTime"])
    return out
