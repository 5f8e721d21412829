"""Host input pipeline: list file -> decoded, batched numpy arrays.

Counterpart of ``acoustic_image_generation_tpu/data/pipeline.py``. The host
does file IO and byte decoding on a thread pool and prefetches batches
ahead of the consumer; all math (MFCC, normalization) happens on the device
in ``data/preprocess.py``, inside the train step. Iteration yields
``RawBatch``es of static shape: a remainder batch is zero-padded, carries
``valid`` and repeats a real window id in its padded rows.

Decoding runs through the C++ library of ``data/native.py`` or the pure
Python codec (``tfrecord``, ``proto``, ``schema``); the two give the same
arrays. ``use_native=None`` takes the library when it builds (as the JAX
package does) and falls back to Python for a shard it cannot decode;
``use_native=True`` raises when the library does not build or a shard does
not decode; ``use_native=False`` decodes in Python. The loader records its
choice in ``decoder``.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from dataclasses import dataclass

import numpy as np

from acoustic_image_generation_tpu_torch.data import native, tfrecord
from acoustic_image_generation_tpu_torch.data.schema import DecodedRecord, decode_record
from acoustic_image_generation_tpu_torch.data.windowing import plan_windows


@dataclass
class RawBatch:
    """Decoded but un-preprocessed batch. ``valid`` counts real rows; padded
    rows (static-shape remainder handling) are zero-filled."""

    acoustic: np.ndarray  # (N, F, 36, 48, C) float32
    audio: np.ndarray  # (N, F, 1024) int32
    video: np.ndarray  # (N, F, 224, 298, 3) uint8
    action: np.ndarray  # (N,) int32
    location: np.ndarray  # (N,) int32
    valid: int
    # dataset-specific extras, each (N, ...): FlickrSoundNet boxes
    # (xmin/xmax/ymin/ymax (N, F, 3) int32), AVE `event` ids, 2-object
    # `classnumber`
    extras: dict | None = None
    # stable per-epoch window identities (indices into plan.windows),
    # shape (N,); padded rows repeat the last real id. Used by the
    # frozen-trunk feature cache (train/feature_cache.py) to key cached
    # trunk features across epochs.
    window_ids: np.ndarray | None = None

    @property
    def frames(self) -> int:
        return self.acoustic.shape[1]


class AcousticImageDataLoader:
    """Windowed, batched loader over per-second TFRecord shards."""

    def __init__(
        self,
        txt_file: str,
        mode: str,
        batch_size: int,
        *,
        sample_length: int = 1,
        embedding: bool = True,
        shuffle: bool | None = None,
        datakind: str = "outdoor",
        num_channels: int | None = None,
        modalities: tuple[int, ...] = (0, 1, 2),
        num_io_threads: int = 8,
        prefetch_batches: int = 2,
        drop_remainder: bool | None = None,
        seed: int = 0,
        use_native: bool | None = None,
        include_boxes: bool = False,
        include_extras: tuple[str, ...] = (),
        cache_windows: bool = False,
        cache_bytes: int = 8 << 30,
        shard_index: int = 0,
        shard_count: int = 1,
    ) -> None:
        assert txt_file is not None
        assert 0 <= shard_index < shard_count, (shard_index, shard_count)
        assert batch_size % shard_count == 0, (
            f"global batch_size {batch_size} must divide evenly over "
            f"{shard_count} host shards"
        )
        self.mode = mode
        self.batch_size = batch_size
        self.sample_length = sample_length
        self.embedding = embedding
        self.datakind = datakind
        self.num_channels = num_channels or (13 if datakind == "music" else 12)
        self.include_acoustic = 0 in modalities
        self.include_audio = 1 in modalities
        self.include_video = 2 in modalities
        self.shuffle = (mode == "training") if shuffle is None else shuffle
        self.drop_remainder = (mode == "training") if drop_remainder is None else drop_remainder
        self.num_io_threads = num_io_threads
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        # Host sharding: every shard derives the same global shuffled window
        # order from (seed, epoch) and decodes only its contiguous row slice
        # of each global batch, so the shards tile the global batch; all
        # shards yield the same number of batches, padding rows they lack.
        self.shard_index = shard_index
        self.shard_count = shard_count

        self.include_boxes = include_boxes
        self.extra_context = tuple(include_extras)
        if include_boxes or self.extra_context:
            # extras only flow through the Python decoder
            if use_native:
                raise ValueError("box and context extras need use_native=False or None")
            use_native = False
        self._strict_native = use_native is True
        if use_native is None:
            use_native = native.available()
        elif use_native and not native.available():
            raise RuntimeError(f"use_native=True but the ingest library did not build: {native.build_error()}")
        self._use_native = use_native
        self.decoder = "native" if use_native else "python"

        self.plan = plan_windows(txt_file, mode, sample_length)
        self.num_samples = self.plan.num_samples
        self.frames_per_window = 12 * sample_length

        # Decoded-window cache: when the decoded windows fit the byte budget,
        # epochs 2+ skip file IO and decoding. Once full, the remaining
        # windows keep decoding every epoch. A lock guards the byte counter
        # against the producer's threads.
        self._window_cache: dict[int, DecodedRecord] | None = (
            {} if cache_windows else None
        )
        self._cache_bytes_budget = cache_bytes
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()

    @property
    def total_batches(self) -> int:
        return self.plan.total_batches(self.batch_size)

    @property
    def local_batch_size(self) -> int:
        """Rows this host yields per batch (= batch_size unless sharded)."""
        return self.batch_size // self.shard_count

    @property
    def num_windows(self) -> int:
        return len(self.plan.windows)

    # ------------------------------------------------------------- decoding

    def _decode_window_by_index(self, idx: int) -> DecodedRecord:
        cache = self._window_cache
        if cache is not None:
            hit = cache.get(idx)
            if hit is not None:
                return hit
        rec = self._decode_window(self.plan.windows[idx])
        if cache is not None:
            nbytes = sum(
                a.nbytes
                for a in (rec.acoustic, rec.audio, rec.video)
                if a is not None
            )
            with self._cache_lock:
                # re-check membership: two iterators can decode the same
                # window concurrently, and charging it twice would make
                # the byte counter refuse later windows early
                if (
                    idx not in cache
                    and self._cache_bytes + nbytes <= self._cache_bytes_budget
                ):
                    cache[idx] = rec
                    self._cache_bytes += nbytes
        return rec

    def _decode_window(self, files: list[str]) -> DecodedRecord:
        if self._use_native:
            try:
                return self._decode_window_native(files)
            except IOError:
                if self._strict_native:
                    raise
        return self._decode_window_python(files)

    def _decode_window_native(self, files: list[str]) -> DecodedRecord:
        """C++ path: decode straight into the window slab (data/native.py
        -> cpp/ingest.cc)."""
        fps = 12
        f = fps * len(files)
        c = self.num_channels
        acoustic = np.empty((f, 36, 48, c), np.float32) if self.include_acoustic else None
        audio = np.empty((f, 1024), np.int32) if self.include_audio else None
        video = np.empty((f, 224, 298, 3), np.uint8) if self.include_video else None
        action = location = 0
        for i, path in enumerate(files):
            sl = slice(i * fps, (i + 1) * fps)
            action, location, _ = native.decode_file_into(
                path,
                acoustic[sl] if acoustic is not None else None,
                audio[sl] if audio is not None else None,
                video[sl] if video is not None else None,
            )
        if acoustic is not None and self.datakind != "music":
            # the parse-time left/right + up/down flips of
            # schema.decode_record's default
            acoustic = np.ascontiguousarray(acoustic[:, ::-1, ::-1, :])
        return DecodedRecord(
            acoustic=acoustic, audio=audio, video=video,
            action=action, location=location, extras={},
        )

    def _decode_window_python(self, files: list[str]) -> DecodedRecord:
        records = []
        for path in files:
            for payload in tfrecord.read_records(path):
                records.append(
                    decode_record(
                        payload,
                        datakind=self.datakind,
                        include_acoustic=self.include_acoustic,
                        include_audio=self.include_audio,
                        include_video=self.include_video,
                        num_channels=self.num_channels,
                    )
                )
        first = records[0]

        def cat(key):
            # a modality can be requested but absent from the shard (e.g.
            # FlickrSoundNet has no acoustic images): the window reports
            # None and _assemble zero-fills the slab
            parts = [getattr(r, key) for r in records]
            if any(p is None for p in parts):
                return None
            return np.concatenate(parts)

        return DecodedRecord(
            acoustic=cat("acoustic") if self.include_acoustic else None,
            audio=cat("audio") if self.include_audio else None,
            video=cat("video") if self.include_video else None,
            action=first.action,
            location=first.location,
            extras=first.extras,
        )

    def _assemble(self, windows: list[DecodedRecord], valid: int) -> RawBatch:
        f = self.frames_per_window
        n = len(windows)
        c = self.num_channels
        acoustic = np.zeros((n, f, 36, 48, c), np.float32)
        audio = np.zeros((n, f, 1024), np.int32)
        video = np.zeros((n, f, 224, 298, 3), np.uint8)
        action = np.zeros((n,), np.int32)
        location = np.zeros((n,), np.int32)
        extras: dict | None = None
        if self.include_boxes:
            extras = {k: np.zeros((n, f, 3), np.int32)
                      for k in ("xmin", "xmax", "ymin", "ymax", "typescene")}
        for key in self.extra_context:
            extras = extras or {}
            extras[key] = np.zeros((n,), np.int32)
        for i, w in enumerate(windows[:valid]):
            if w.acoustic is not None:
                acoustic[i] = w.acoustic
            if w.audio is not None:
                audio[i] = w.audio
            if w.video is not None:
                video[i] = w.video
            action[i] = w.action
            location[i] = w.location
            if self.include_boxes:
                for k in ("xmin", "xmax", "ymin", "ymax", "typescene"):
                    if k in w.extras:
                        extras[k][i] = w.extras[k]
            for key in self.extra_context:
                if key in w.extras:
                    extras[key][i] = w.extras[key]
        return RawBatch(acoustic, audio, video, action, location, valid, extras)

    # ------------------------------------------------------------- iteration

    def batches(self, epoch: int = 0):
        """Yield RawBatches for one epoch, decoding on a thread pool and
        prefetching ``prefetch_batches`` ahead of the consumer."""
        order = np.arange(self.num_windows)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)

        bs = self.batch_size
        n_full = self.num_windows // bs
        idx_batches = [order[i * bs : (i + 1) * bs] for i in range(n_full)]
        rem = self.num_windows - n_full * bs
        if rem and not self.drop_remainder:
            idx_batches.append(order[n_full * bs :])

        # Host shard: each host owns a contiguous row slice of every
        # global batch. A remainder batch may leave a host with fewer (or
        # zero) real rows; it still yields a static-shape batch so all
        # hosts run the same number of steps.
        lbs = self.local_batch_size
        lo = self.shard_index * lbs

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.num_io_threads) as pool:
                    for idxs in idx_batches:
                        if stop.is_set():
                            return
                        valid = max(0, min(len(idxs) - lo, lbs))
                        local = idxs[lo : lo + valid]
                        decoded = list(
                            pool.map(self._decode_window_by_index, local)
                        )
                        ids = np.asarray(local, np.int64)
                        if valid < lbs:
                            # pad to static shape; padded rows are
                            # zero-filled by _assemble and masked by
                            # ``valid``, so only their ids matter (repeat
                            # a real window id so cache gathers resolve)
                            pad_id = ids[-1] if valid else np.int64(idxs[-1])
                            decoded += [decoded[-1] if valid else None] * (
                                lbs - valid
                            )
                            ids = np.concatenate(
                                [ids, np.full((lbs - valid,), pad_id, np.int64)]
                            )
                        batch = self._assemble(decoded, valid)
                        batch.window_ids = ids
                        out_q.put(batch)
                out_q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
