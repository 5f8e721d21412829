"""Profiling and throughput counters on ``torch.profiler`` and ``torch.cuda``.

Counterpart of ``acoustic_image_generation_tpu/utils/profiling.py``:

- ``trace(logdir)``: a context manager over ``torch.profiler.profile``
  (CPU activities, and CUDA activities where a GPU is visible) that
  writes a Chrome trace, ``*.pt.trace.json``, under ``logdir``;
- ``StepTimer``: steps/s and clips/s after a warmup, JAX's counters;
- ``op_stats(logdir, steps, top)``: the newest trace under ``logdir`` as
  per-step op statistics with JAX's keys;
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` of each visible
  device.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import time

import torch

# the trace's event categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its Chrome trace under ``logdir``: CPU
    activities, and CUDA activities where a GPU is visible, whose device is
    synchronized before the trace ends, so its last kernels are in it.
    Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    """Steps/s and clips/s over the steps after the first ``warmup`` ones
    (the first runs build and tune kernels). The clock is the host's: the
    caller synchronizes the device (``torch.cuda.synchronize()``, or reads
    a result on the host) before each ``step()`` and before reading the
    rates, as JAX's caller blocks on the step's result."""

    def __init__(self, clips_per_step: float, warmup: int = 2):
        self.clips_per_step = clips_per_step
        self.warmup = warmup
        self.count = 0
        self._t0 = None
        self.steps_timed = 0

    def step(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.perf_counter()
        elif self.count > self.warmup:
            self.steps_timed = self.count - self.warmup

    @property
    def seconds(self) -> float:
        if self._t0 is None:
            return 0.0
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        s = self.seconds
        return self.steps_timed / s if s > 0 else 0.0

    @property
    def clips_per_sec(self) -> float:
        return self.steps_per_sec * self.clips_per_step


def _newest_trace(logdir: str) -> str:
    paths = [p for pattern in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.trace.json or *.trace.json.gz under {logdir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def _outermost(events: list) -> list:
    """The events of one lane that no other event of it contains (a CPU op
    lane nests ``aten::linear`` over ``aten::addmm``; counted once)."""
    out, end = [], float("-inf")
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        if e["ts"] >= end:
            out.append(e)
            end = e["ts"] + e["dur"]
    return out


def op_stats(logdir: str, steps: int = 1, top: int = 20) -> dict:
    """Per-step op statistics of the newest trace under ``logdir``, JAX's
    keys, each time divided by ``steps``:

    - ``total_ms``: the lane's busy time a step;
    - ``by_category``: rows ``(category, ms, pct, gb_accessed, gbps)`` by
      the event's own ``cat`` (``kernel``, ``gpu_memcpy``, ``gpu_memset``;
      ``cpu_op`` on a CPU-only capture), sorted by time;
    - ``top_ops``: the ``top`` ops by time (``op``, ``ms``, ``gb_accessed``,
      ``long_name``: for a kernel its name with its grid and block).

    It reads the busiest lane (process and thread: a device and a stream)
    of device events. A capture without any reads the busiest lane of CPU
    ops instead, their outermost ops only, as JAX's falls back to host
    lanes. Bytes come from the events' ``bytes`` argument, which the trace
    records for copies and memsets; elsewhere ``gb_accessed`` is 0."""
    path = _newest_trace(logdir)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    pool = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    on_device = bool(pool)
    if not on_device:
        pool = [e for e in spans if e.get("cat") == "cpu_op"]
    if not pool:
        raise ValueError(f"no device events and no CPU ops in {path}")
    lanes: dict = collections.defaultdict(float)
    for e in pool:
        lanes[(e.get("pid"), e.get("tid"))] += e["dur"]
    lane = max(lanes, key=lanes.get)
    ops = [e for e in pool if (e.get("pid"), e.get("tid")) == lane]
    if not on_device:
        ops = _outermost(ops)

    cat = collections.defaultdict(lambda: [0.0, 0.0])
    per_op = collections.defaultdict(lambda: [0.0, 0.0, ""])
    for e in ops:
        a = e.get("args", {})
        ms = e["dur"] / 1e3 / steps
        gb = float(a.get("bytes", 0)) / 1e9 / steps
        c = e.get("cat", "other")
        cat[c][0] += ms
        cat[c][1] += gb
        o = per_op[e["name"]]
        o[0] += ms
        o[1] += gb
        o[2] = e["name"] + (f" grid {a['grid']} block {a['block']}" if "grid" in a and "block" in a else "")
    total_ms = sum(v[0] for v in cat.values())
    by_category = [
        {
            "category": k,
            "ms": round(v[0], 3),
            "pct": round(100 * v[0] / total_ms, 1) if total_ms else 0.0,
            "gb_accessed": round(v[1], 3),
            "gbps": round(v[1] / (v[0] / 1e3), 1) if v[0] else 0.0,
        }
        for k, v in sorted(cat.items(), key=lambda kv: -kv[1][0])
    ]
    top_ops = [
        {"op": k, "ms": round(v[0], 3), "gb_accessed": round(v[1], 3), "long_name": v[2][:200]}
        for k, v in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    ]
    return {"total_ms": round(total_ms, 3), "by_category": by_category, "top_ops": top_ops}


def device_memory_stats() -> list[dict]:
    """``torch.cuda.memory_stats`` of each visible GPU as
    ``{"device": "cuda:i", <stat>: int, ...}`` (for example
    ``allocated_bytes.all.peak``); ``[]`` without a GPU."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out.append({"device": f"cuda:{i}", **{k: int(v) for k, v in stats.items()}})
    return out
