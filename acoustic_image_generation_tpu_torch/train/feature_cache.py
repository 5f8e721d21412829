"""Frozen-trunk feature cache: run the ResNet trunk once per window.

Counterpart of ``acoustic_image_generation_tpu/train/feature_cache.py``.
With ``trunk_bn="frozen"`` the trunk is a fixed function of each video
frame, so its block4 output (the input of the trainable ``conv_map``) can be
computed once per window and reused every epoch; steady-state training then
runs the head and the generator only. Validity rests on the frozen-trunk
invariant: neither the trunk's weights nor its BN statistics change within
a ``Trainer``'s lifetime.

Tiers, keyed by the loader's window ids (``RawBatch.window_ids``):

- ``DeviceFeatureCache``: one preallocated ``(capacity, frames, 14, 19,
  2048)`` tensor on the card; a step gathers its rows with ``index_select``,
  so no feature bytes cross PCIe;
- ``TrunkFeatureCache``: host RAM, CPU tensors (numpy has no bfloat16 or
  float8), bounded by ``max_bytes``;
- ``DiskFeatureStore``: the cross-run tier behind the host tier, one raw
  ``w{wid}.bin`` per window and a ``manifest.json``, in the JAX package's
  format (dtype names ``bfloat16``, ``float8_e4m3fn``, ``float32``), so
  either package reads the other's store.

Window ids are loader-local, so each loader needs its own cache: the
``Trainer`` keeps one for training and one per eval loader.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections.abc import Mapping

import torch

# the dtype names of the store's manifest (numpy / ml_dtypes names)
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn", torch.float32: "float32"}
_DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


F8_OVERFLOW = 464.0  # above it, round-to-nearest-even leaves e4m3fn's range (448)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its uint8 bits (torch's index and concatenation
    ops skip float8), any other tensor as it is; ``.view(dtype)`` turns the
    result back."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def to_float8_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """Round ``x`` to ``float8_e4m3fn`` as XLA and ml_dtypes do: to nearest
    even, with NaN (of ``x``'s sign) where the rounded magnitude passes 448
    and for infinities. torch's cast saturates there instead (to +-448), so
    those entries are set to NaN afterwards; everywhere else the two casts
    agree bit for bit."""
    q = x.to(torch.float8_e4m3fn).view(torch.uint8)
    return torch.where(x.abs() > F8_OVERFLOW, q | 0x7F, q).view(torch.float8_e4m3fn)


class TrunkFeatureCache:
    """Bounded host cache: window id -> (frames, 14, 19, 2048) CPU tensor.

    With a ``disk`` store attached, every row is written through to disk
    and RAM misses fall back to it (promoting the row into RAM while the
    budget allows)."""

    def __init__(self, max_bytes: int = 32 << 30, disk: "DiskFeatureStore | None" = None) -> None:
        self.max_bytes = max_bytes
        self.disk = disk
        self._store: dict[int, torch.Tensor] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def attach_disk(self, disk: "DiskFeatureStore") -> None:
        self.disk = disk

    def __contains__(self, window_id: int) -> bool:
        wid = int(window_id)
        return wid in self._store or (self.disk is not None and wid in self.disk)

    def get(self, window_id: int) -> torch.Tensor | None:
        wid = int(window_id)
        feat = self._store.get(wid)
        if feat is None and self.disk is not None:
            feat = self.disk.get(wid)
            if feat is not None and self._bytes + nbytes(feat) <= self.max_bytes:
                self._store[wid] = feat
                self._bytes += nbytes(feat)
        if feat is None:
            self.misses += 1
        else:
            self.hits += 1
        return feat

    def put(self, window_id: int, feat: torch.Tensor, *, ram: bool = True) -> bool:
        """Store one window's features (written through to disk when a
        store is attached; ``ram=False`` writes disk only, for rows resident
        in the device pool). True iff the row is now held by some tier."""
        wid = int(window_id)
        on_disk = self.disk.put(wid, feat) if self.disk is not None else False
        if not ram:
            return on_disk
        if wid in self._store:
            return True
        if self._bytes + nbytes(feat) > self.max_bytes:
            return on_disk
        self._store[wid] = feat
        self._bytes += nbytes(feat)
        return True

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._store)


def gather_batch(cache: TrunkFeatureCache, window_ids, valid: int) -> torch.Tensor | None:
    """A batch's cached features as one CPU tensor (N*F, 14, 19, 2048), in
    the flattened frame order of ``Trainer._prepare``, or None if a valid
    window is missing. Padded rows repeat the last valid row."""
    feats = []
    for i, wid in enumerate(window_ids):
        if i >= valid and feats:
            feats.append(feats[-1])
            continue
        f = cache.get(int(wid))
        if f is None:
            return None
        feats.append(as_bytes(f))
    return torch.cat(feats).view(f.dtype)


class DeviceFeatureCache:
    """Device-resident tier in front of the host cache: a pool of windows
    held as one ``(capacity, frames, 14, 19, 2048)`` tensor on the card,
    allocated at the first insert with ``capacity = max_bytes // window
    bytes``. Windows that do not fit stay in the host tier."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = max_bytes
        self.buf: torch.Tensor | None = None
        self.slots: dict[int, int] = {}
        self._next = 0
        self._capacity = 0

    def lookup_partial(self, window_ids, valid: int):
        """``(slots, missing)``: one slot id per row (0 for rows not
        resident), and ``[(row, window_id), ...]`` for the valid rows the
        pool lacks. None while the pool is empty. Padded rows repeat the
        last valid slot."""
        if self.buf is None:
            return None
        slots = [0] * len(window_ids)
        missing: list[tuple[int, int]] = []
        last = 0
        for i, wid in enumerate(window_ids):
            if i >= valid:
                slots[i] = last
                continue
            s = self.slots.get(int(wid))
            if s is None:
                missing.append((i, int(wid)))
            else:
                slots[i] = last = s
        return slots, missing

    def put_batch(self, window_ids, valid: int, feat: torch.Tensor, frames: int) -> None:
        """Insert freshly computed features (a device tensor (N*frames,
        ...)) for as many new windows as the budget allows."""
        per_window = frames * feat[0].numel() * feat.element_size()
        if self.buf is None:
            self._capacity = int(self.max_bytes // max(per_window, 1))
            if self._capacity <= 0:
                return
            self.buf = torch.zeros((self._capacity, frames, *feat.shape[1:]), dtype=as_bytes(feat).dtype,
                                   device=feat.device).view(feat.dtype)
        rows, idx = [], []
        for i, wid in enumerate(window_ids[:valid]):
            wid = int(wid)
            if wid in self.slots or self._next >= self._capacity:
                continue
            self.slots[wid] = self._next
            rows.append(i)
            idx.append(self._next)
            self._next += 1
        if not rows:
            return
        shaped = as_bytes(feat).reshape(-1, frames, *feat.shape[1:])
        device = self.buf.device
        picked = shaped.index_select(0, torch.tensor(rows, device=device))
        as_bytes(self.buf).index_copy_(0, torch.tensor(idx, device=device), picked)

    def gather(self, slots, rows=None) -> torch.Tensor:
        """The pool's windows at ``slots``, as (len(slots)*frames, 14, 19,
        2048); ``rows``, ``(positions, features (m, frames, 14, 19, 2048))``
        on the host, replaces the windows at those positions (the mixed
        tier: only those rows cross PCIe)."""
        device = self.buf.device
        feat = as_bytes(self.buf).index_select(0, torch.tensor(slots, device=device))
        if rows is not None:
            pos, host = rows
            feat.index_copy_(0, torch.tensor(pos, device=device), as_bytes(host).to(device, non_blocking=True))
        return feat.view(self.buf.dtype).reshape(-1, *feat.shape[2:])

    @property
    def resident(self) -> int:
        return len(self.slots)


class DiskFeatureStore:
    """Cross-run disk tier. One directory per ``fingerprint`` (a digest of
    everything the features depend on, ``Trainer._attach_disk``) holds one
    raw ``w{wid}.bin`` per window and ``manifest.json`` with the uniform
    per-window shape and dtype name. Writes are atomic (a temporary file,
    then ``os.replace``), so concurrent runs over the same dataset can share
    a store. The byte budget counts the files already there."""

    def __init__(self, root: str, fingerprint: str, *, max_bytes: int = 256 << 30):
        self.dir = os.path.join(root, fingerprint[:24])
        os.makedirs(self.dir, exist_ok=True)
        self.max_bytes = max_bytes
        self._manifest = os.path.join(self.dir, "manifest.json")
        self.meta: dict | None = None
        if os.path.exists(self._manifest):
            try:
                with open(self._manifest) as f:
                    self.meta = json.load(f)
            except (OSError, ValueError):
                self.meta = None
        self._index: set[int] = set()
        self._bytes = 0
        for name in os.listdir(self.dir):
            if name.startswith("w") and name.endswith(".bin"):
                try:
                    wid = int(name[1:-4])
                except ValueError:
                    continue
                self._index.add(wid)
                try:
                    self._bytes += os.path.getsize(os.path.join(self.dir, name))
                except OSError:
                    pass

    def __contains__(self, window_id: int) -> bool:
        return int(window_id) in self._index

    def __len__(self) -> int:
        return len(self._index)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def _path(self, wid: int) -> str:
        return os.path.join(self.dir, f"w{wid}.bin")

    def get(self, window_id: int) -> torch.Tensor | None:
        wid = int(window_id)
        if self.meta is None or wid not in self._index:
            return None
        try:
            with open(self._path(wid), "rb") as f:
                data = bytearray(os.fstat(f.fileno()).st_size)
                f.readinto(data)
        except OSError:
            self._index.discard(wid)
            return None
        return torch.frombuffer(data, dtype=_DTYPES[self.meta["dtype"]]).reshape(self.meta["shape"])

    def put(self, window_id: int, feat: torch.Tensor) -> bool:
        wid = int(window_id)
        if wid in self._index:
            return True
        feat = feat.detach().cpu().contiguous()
        name = DTYPE_NAMES[feat.dtype]
        if self.meta is None:
            self.meta = {"dtype": name, "shape": list(feat.shape)}
            tmp = self._manifest + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.meta, f)
            os.replace(tmp, self._manifest)
        elif list(feat.shape) != list(self.meta["shape"]) or name != self.meta["dtype"]:
            return False  # different geometry: refuse rather than corrupt
        if self._bytes + nbytes(feat) > self.max_bytes:
            return False
        tmp = self._path(wid) + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(feat.reshape(-1).view(torch.uint8).numpy().tobytes())
        os.replace(tmp, self._path(wid))
        self._index.add(wid)
        self._bytes += nbytes(feat)
        return True


def tree_fingerprint(*trees: Mapping[str, torch.Tensor], digest_size: int = 20) -> str:
    """Content digest of named tensors (name, dtype, shape and bytes, in
    sorted name order): the identity of a ``DiskFeatureStore``. Two runs
    share features iff everything the features depend on hashes equal."""
    h = hashlib.blake2b(digest_size=digest_size)
    for tree in trees:
        for name in sorted(tree):
            t = tree[name].detach().cpu().contiguous().reshape(-1)
            h.update(name.encode() + str(t.dtype).encode() + str(tuple(tree[name].shape)).encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def windows_fingerprint(loader, digest_size: int = 20) -> str:
    """Digest of a loader's window table (window id -> record paths): keeps
    a store from serving another dataset or windowing."""
    h = hashlib.blake2b(digest_size=digest_size)
    for window in loader.plan.windows:
        for path in window:
            h.update(path.encode() + b"\0")
        h.update(b"\1")
    return h.hexdigest()
