"""TUT/DCASE acoustic-scene audio loader, on the host.

Counterpart of ``acoustic_image_generation_tpu/data/tut.py``. Shards are
plain ``tf.train.Example`` records (``data/proto.py::Example``) with a
raw-int64 ``label`` and a raw-float32 ``audio_raw`` waveform of
``min_length`` (10) seconds at 22050 Hz. Training yields
``number_of_crops`` random ``sample_length``-second crops a record;
inference yields ``min_length / sample_length`` equispaced crops. The crops
and the shuffle come from ``np.random.default_rng(seed + epoch)``, the
same draws as JAX's loader. Optional global z-normalization from
``stats_dir/global_mean.npy`` and ``global_std_dev.npy``. The spectrogram
is ``dsp.spectrogram.stft_magnitude(wav, **spectrogram_params())`` (frame
440, step 219, FFT 512), the plain product on any device: the ``stft``
kernel serves the 246/122/512 geometry only.

Shards come from a directory or a list file; batches are numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np

from acoustic_image_generation_tpu_torch.data import tfrecord
from acoustic_image_generation_tpu_torch.data.proto import Example, Feature

SAMPLE_RATE = 22050
MIN_LENGTH = 10
FRAME_LENGTH = 440
FRAME_STEP = 219
FFT_LENGTH = 512


def spectrogram_params() -> dict:
    """Keyword arguments of ``dsp.spectrogram.stft_magnitude`` for the TUT
    geometry."""
    return {
        "frame_length": FRAME_LENGTH,
        "frame_step": FRAME_STEP,
        "fft_length": FFT_LENGTH,
    }


def decode_tut_record(payload: bytes) -> tuple[np.ndarray, int]:
    """One record -> (waveform float32 (min_length*rate,), label int)."""
    ex = Example.decode(payload)
    audio = np.frombuffer(ex.features["audio_raw"].bytes_list[0], np.float32)
    label = int(np.frombuffer(ex.features["label"].bytes_list[0], np.int64)[0])
    return audio, label


def encode_tut_record(audio: np.ndarray, label: int) -> bytes:
    """Inverse of ``decode_tut_record``."""
    ex = Example()
    ex.features["audio_raw"] = Feature(
        bytes_list=[np.ascontiguousarray(audio, np.float32).tobytes()]
    )
    ex.features["label"] = Feature(
        bytes_list=[np.asarray([label], np.int64).tobytes()]
    )
    return ex.encode()


class TUTDataLoader:
    """Crop-and-batch loader over TUT shards (see module docstring)."""

    def __init__(
        self,
        source: str,
        mode: str,
        batch_size: int,
        *,
        num_classes: int = 15,
        sample_length: int = 2,
        number_of_crops: int = 5,
        min_length: int = MIN_LENGTH,
        sample_rate: int = SAMPLE_RATE,
        normalize: bool = False,
        stats_dir: str | None = None,
        shuffle: bool | None = None,
        seed: int = 0,
    ) -> None:
        if mode not in ("training", "inference"):
            raise ValueError(f"mode is 'training' or 'inference', got {mode!r}")
        self.mode = mode
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.sample_length = sample_length
        self.number_of_crops = number_of_crops
        self.segment = int(sample_length * sample_rate)
        self.record_len = int(min_length * sample_rate)
        self.crops_per_record = (
            number_of_crops if mode == "training" else min_length // sample_length
        )
        self.shuffle = (mode == "training") if shuffle is None else shuffle
        self.seed = seed

        if os.path.isdir(source):
            self.paths = sorted(
                os.path.join(source, f)
                for f in os.listdir(source)
                if f.endswith((".tfrecord", ".tfrecords"))
            )
        else:
            with open(source) as f:
                self.paths = [line.strip() for line in f if line.strip()]
        self.records = []
        for p in self.paths:
            self.records.extend(tfrecord.read_records(p))
        self.num_samples = len(self.records) * self.crops_per_record

        self.global_mean = self.global_std = None
        if normalize:
            if not stats_dir:
                raise ValueError("normalize=True needs stats_dir")
            self.global_mean = np.load(os.path.join(stats_dir, "global_mean.npy"))
            self.global_std = np.load(os.path.join(stats_dir, "global_std_dev.npy"))

    @property
    def total_batches(self) -> int:
        return self.num_samples // self.batch_size

    def batches(self, epoch: int = 0):
        """Yield (audio (N, segment) float32, labels (N,) int32)."""
        rng = np.random.default_rng(self.seed + epoch)
        audio_all, labels_all = [], []
        for payload in self.records:
            wav, label = decode_tut_record(payload)
            if wav.shape[0] < self.record_len:
                raise ValueError(f"a record of {wav.shape[0]} samples, shorter than {self.record_len}")
            if self.mode == "training":
                starts = rng.integers(
                    self.record_len - self.segment, size=self.crops_per_record
                )
            else:
                starts = np.arange(self.crops_per_record) * self.segment
            for s in starts:
                audio_all.append(wav[s : s + self.segment])
                labels_all.append(label)
        audio = np.stack(audio_all)
        labels = np.asarray(labels_all, np.int32)
        if self.shuffle:
            order = rng.permutation(len(labels))
            audio, labels = audio[order], labels[order]
        if self.global_mean is not None:
            audio = (audio - self.global_mean) / self.global_std
        n_full = len(labels) // self.batch_size
        for i in range(n_full):
            sl = slice(i * self.batch_size, (i + 1) * self.batch_size)
            yield audio[sl], labels[sl]
