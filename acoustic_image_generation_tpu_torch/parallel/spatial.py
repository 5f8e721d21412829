"""Spatial sharding: one request's image rows split over devices.

Counterpart of ``acoustic_image_generation_tpu/parallel/mesh.py::
spatial_sharding``. JAX splits an NHWC batch's height over its mesh's first
axis and GSPMD inserts the halo exchanges the convolution windows need. For
latency: a request whose batch is smaller than the mesh still uses every
device. JAX's form is one program over ``n`` local devices, so here it is
one process over a list of ``n`` devices; no ``torch.distributed`` is
involved, and a list may name one device more than once (the shards then
run one after another on it).

- ``split_rows(height, n)``: a layer's output rows per shard, balanced (the
  first ``height % n`` shards one row longer: 12 rows over 8 shards are
  2,2,2,2,1,1,1,1). Every layer gets its own split of its own output rows:
  the heights along the ResNet trunk (224 -> 112 -> 55 -> 28 -> 14 -> 12)
  are no chain of halvings.
- ``window(rows, kernel, stride, pad_lo)``: the input rows ``[r0*s - pad_lo,
  (r1-1)*s - pad_lo + k)`` that output rows ``[r0, r1)`` read.
- ``Rows``: the row blocks of one NHWC tensor, block ``i`` on ``devices[i]``
  with its global rows ``bounds[i]``. ``take`` is the halo fetch: the rows of
  a window on shard ``i``'s device, each slice copied from the shard that
  owns it (``.to(device)``), zero rows past the image border (the layer's
  own padding, never a neighbour's rows).
- ``layer(x, kernel, stride, pads, fn)``: one layer on row blocks: shard
  ``i`` runs ``fn(i, window)`` on its window, with no padding of rows (the
  window holds it) and the layer's own padding of columns.
- ``record()``: while open, every ``layer`` appends what it ran (the rows
  each shard computed, the rows it was fed, the halo bytes it fetched), the
  plan the tests check and the chip script logs.
- ``replicas(module, devices)``: one copy of a module's weights per
  distinct device.

A split needs at least one row a shard at every layer, so ``n`` may not
exceed ``MAX_SHARDS``, the 12 rows of ``conv_map``'s output, the least height
on the split path (``check_shards``). GSPMD would pad instead.
"""

from __future__ import annotations

import contextlib
import copy

import torch

MAX_SHARDS = 12  # conv_map's output rows, the least height the trunk's split path has

_records: list | None = None


def check_shards(n: int) -> int:
    """``n`` as an int, when 1 <= n <= MAX_SHARDS; else ``ValueError``."""
    if isinstance(n, bool) or int(n) != n or n < 1:
        raise ValueError(f"spatial_shards must be a positive int, got {n!r}")
    if n > MAX_SHARDS:
        raise ValueError(f"spatial_shards={n} exceeds the {MAX_SHARDS} rows of conv_map's output, the least height "
                         f"a shard's rows are taken from: each shard needs at least one row at every layer")
    return int(n)


def split_rows(height: int, n: int) -> list[tuple[int, int]]:
    """``[r0, r1)`` of each of ``n`` shards over ``height`` rows, balanced,
    the longer blocks first."""
    if height < n:
        raise ValueError(f"{height} rows cannot be split over {n} shards")
    base, extra = divmod(height, n)
    out, r0 = [], 0
    for i in range(n):
        r1 = r0 + base + (i < extra)
        out.append((r0, r1))
        r0 = r1
    return out


def window(rows: tuple[int, int], kernel: int, stride: int, pad_lo: int) -> tuple[int, int]:
    """The input rows ``[lo, hi)`` that output rows ``rows`` of a layer
    read; ``lo`` below 0 or ``hi`` past the height are padding rows."""
    r0, r1 = rows
    return r0 * stride - pad_lo, (r1 - 1) * stride - pad_lo + kernel


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare ``cuda`` with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Rows:
    """The row blocks of one NHWC tensor of ``height`` rows: ``blocks[i]``
    holds the global rows ``bounds[i]`` on ``devices[i]``."""

    def __init__(self, blocks: list, bounds: list, devices: list, height: int):
        self.blocks, self.bounds, self.devices, self.height = blocks, bounds, devices, height

    @classmethod
    def split(cls, x: torch.Tensor, devices) -> "Rows":
        """``x`` (N,H,W,C) split by rows over ``devices``, balanced, each
        block copied to its device."""
        devices = [as_device(d) for d in devices]
        bounds = split_rows(x.shape[1], len(devices))
        return cls([x[:, r0:r1].to(d) for (r0, r1), d in zip(bounds, devices)], bounds, devices, x.shape[1])

    @property
    def width(self) -> int:
        return self.blocks[0].shape[2]

    def row_bytes(self) -> int:
        b = self.blocks[0]
        return b.shape[0] * b.shape[2] * b.shape[3] * b.element_size()

    def take(self, lo: int, hi: int, i: int) -> torch.Tensor:
        """Global rows ``[lo, hi)`` on shard ``i``'s device: each row from
        the block that holds it, a zero row where the index lies outside the
        image."""
        own = self.blocks[i]
        n, _, w, c = own.shape
        parts = []
        if lo < 0:
            parts.append(own.new_zeros((n, -lo, w, c)))
        for block, (s0, s1) in zip(self.blocks, self.bounds):
            a, b = max(lo, s0), min(hi, s1)
            if a < b:
                parts.append(block[:, a - s0:b - s0].to(self.devices[i]))
        if hi > self.height:
            parts.append(own.new_zeros((n, hi - self.height, w, c)))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def halo_rows(self, lo: int, hi: int, i: int) -> int:
        """How many of the image rows in ``[lo, hi)`` other shards hold."""
        s0, s1 = self.bounds[i]
        inside = max(0, min(hi, self.height) - max(lo, 0))
        return inside - max(0, min(hi, s1) - max(lo, s0))

    def map(self, fn) -> "Rows":
        """``fn(i, block)`` on every block, rows unchanged."""
        return Rows([fn(i, b) for i, b in enumerate(self.blocks)], self.bounds, self.devices, self.height)

    def zip(self, other: "Rows", fn) -> "Rows":
        """``fn(i, mine, theirs)`` block by block; both split alike."""
        if other.bounds != self.bounds:
            raise ValueError(f"row blocks {self.bounds} and {other.bounds} are split differently")
        return Rows([fn(i, a, b) for i, (a, b) in enumerate(zip(self.blocks, other.blocks))], self.bounds,
                    self.devices, self.height)

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        device = as_device(device)
        return torch.cat([b.to(device) for b in self.blocks], dim=1)


def layer(x: Rows, kernel: int, stride: int, pads: tuple[int, int], fn, name: str = "") -> Rows:
    """A layer of row ``kernel``, ``stride`` and row padding ``pads`` (low,
    high) on row blocks: each shard's output rows (a balanced split of the
    layer's output height) from ``fn(i, window)``, the window holding the
    input rows they read, its padding rows zero. ``fn`` pads no rows."""
    out_h = (x.height + pads[0] + pads[1] - kernel) // stride + 1
    bounds = split_rows(out_h, len(x.blocks))
    blocks, windows, fed, halo = [], [], [], 0
    for i, rows in enumerate(bounds):
        lo, hi = window(rows, kernel, stride, pads[0])
        win = x.take(lo, hi, i)
        y = fn(i, win)
        if y.shape[1] != rows[1] - rows[0]:
            raise AssertionError(f"{name}: shard {i} made {y.shape[1]} rows, expected {rows[1] - rows[0]}")
        blocks.append(y)
        windows.append((lo, hi))
        fed.append(win.shape[1])
        halo += x.halo_rows(lo, hi, i) * x.row_bytes()
    if _records is not None:
        _records.append(dict(name=name, kernel=kernel, stride=stride, pads=tuple(pads), in_height=x.height,
                             in_rows=list(x.bounds), out_height=out_h, out_rows=bounds, windows=windows, fed=fed,
                             halo_bytes=halo))
    return Rows(blocks, bounds, x.devices, out_h)


@contextlib.contextmanager
def record():
    """Collect a record of every ``layer`` run inside the block into the
    list it yields."""
    global _records
    saved, _records = _records, []
    try:
        yield _records
    finally:
        _records = saved


def replicas(module: torch.nn.Module, devices) -> list:
    """``module`` for each of ``devices``: itself on the device its weights
    are on, one deep copy on each other distinct device."""
    home = next(iter([*module.parameters(), *module.buffers()])).device
    copies: dict = {}
    out = []
    for d in map(as_device, devices):
        if d not in copies:
            copies[d] = module if d == as_device(home) else copy.deepcopy(module).to(d)
        out.append(copies[d])
    return out
