"""List-file parsing and clip windowing.

Counterpart of ``acoustic_image_generation_tpu/data/windowing.py``: the list
file names one TFRecord per second; consecutive lines sharing a parent
directory form one video; training uses sliding windows of
``sample_length`` seconds with stride 1, validation and testing
non-overlapping strided windows. ``num_samples`` (the sum of
floor(len/sample_length) per video) feeds ``total_batches``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class WindowPlan:
    windows: list[list[str]]  # each inner list: sample_length record paths
    num_samples: int  # reference-compatible sample count

    def total_batches(self, batch_size: int) -> int:
        return int(math.ceil(self.num_samples / batch_size))


def read_list_file(txt_file: str) -> list[list[str]]:
    """Group record paths by parent video directory (path component -2),
    preserving order, splitting whenever the parent changes."""
    groups: list[list[str]] = []
    name = None
    current: list[str] = []
    with open(txt_file) as f:
        for line in f:
            path = line.rstrip("\n")
            if not path:
                continue
            parent = path.split("/")[-2]
            if parent != name and current:
                groups.append(current)
                current = []
            name = parent
            current.append(path)
    if current:
        groups.append(current)
    return groups


def plan_windows(txt_file: str, mode: str, sample_length: int) -> WindowPlan:
    groups = read_list_file(txt_file)
    windows: list[list[str]] = []
    num_samples = 0
    for files in groups:
        length = len(files)
        num_samples += int(math.floor(length / sample_length))
        if mode == "training":
            for ind in range(length - sample_length + 1):
                windows.append(files[ind : ind + sample_length])
        elif mode in ("validation", "testing"):
            n_crops = int(math.floor(length / sample_length))
            for i in range(n_crops):
                start = i * sample_length
                windows.append(files[start : start + sample_length])
        else:
            raise ValueError(f"Unknown mode {mode!r}")
    return WindowPlan(windows=windows, num_samples=num_samples)
