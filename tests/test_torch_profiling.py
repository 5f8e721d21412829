"""The port's profiling module (``utils/profiling.py``, on
``torch.profiler``) against the JAX package's (on ``jax.profiler``).

What is held: ``op_stats`` of a synthetic torch Chrome trace gives exactly
what JAX's ``op_stats`` gives for an xprof capture of the same events (the
arithmetic of ``tests/test_utils.py``'s synthetic case: per-step times,
categories sorted by time with their shares and rates, top ops), choosing
the device lane over a busier CPU lane and the newest trace under the
directory; a live CPU capture through ``trace`` gives JAX's keys from the
busiest CPU-op lane, each op counted once; ``StepTimer`` counts as JAX's;
``device_memory_stats`` is empty without a GPU.
"""

import gzip
import json
import os
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from acoustic_image_generation_tpu.utils import profiling as jprof
from acoustic_image_generation_tpu_torch.utils import profiling as prof
from torch_threads import few_torch_threads  # noqa: F401

# (lane, category, name, dur in us over two steps, bytes, grid and block)
EVENTS = [
    ((0, 7), "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 12000, 24e9, None),
    ((0, 7), "kernel", "mfcc_kernel", 3000, None, ([96, 1, 1], [256, 1, 1])),
    ((0, 7), "kernel", "mfcc_kernel", 1000, None, ([96, 1, 1], [256, 1, 1])),
    ((0, 7), "gpu_memset", "Memset (Device)", 500, 2e6, None),
    ((0, 8), "kernel", "side_stream_kernel", 2000, None, ([1, 1, 1], [32, 1, 1])),  # a quieter lane
    ((1, 10), "cpu_op", "aten::copy_", 99000, None, None),  # a busier host lane: not read
]


def _torch_trace(path, events):
    out, ts = [], 0.0
    for (pid, tid), cat, name, dur, nbytes, launch in events:
        args = {"device": pid, "stream": tid}
        if nbytes is not None:
            args["bytes"] = int(nbytes)
        if launch is not None:
            args["grid"], args["block"] = launch
        out.append({"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
                    "args": args})
        ts += dur + 1
    out.append({"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "python"}})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with (gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")) as f:
        json.dump({"schemaVersion": 1, "traceEvents": out}, f)


def _xprof_trace(logdir, events):
    """The same events in the layout JAX's ``op_stats`` reads: one "XLA Ops"
    lane of the device process, the CPU op on a host lane, the category in
    ``hlo_category``, the bytes in ``bytes_accessed``."""
    out = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/host:CPU"}},
           {"ph": "M", "name": "thread_name", "pid": 1, "tid": 10, "args": {"name": "XLA Ops"}},
           {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/device:GPU:0"}},
           {"ph": "M", "name": "thread_name", "pid": 2, "tid": 20, "args": {"name": "XLA Ops"}}]
    for (pid, tid), cat, name, dur, nbytes, launch in events:
        if (pid, tid) == (0, 8):
            continue  # JAX's lane holds one stream
        args = {"hlo_category": cat, "long_name": name + (f" grid {launch[0]} block {launch[1]}" if launch else "")}
        if nbytes is not None:
            args["bytes_accessed"] = str(int(nbytes))
        lane = (1, 10) if cat == "cpu_op" else (2, 20)
        out.append({"ph": "X", "pid": lane[0], "tid": lane[1], "name": name, "dur": dur, "args": args})
    cap = os.path.join(logdir, "plugins", "profile", "2026_01_01_00_00_00")
    os.makedirs(cap)
    with gzip.open(os.path.join(cap, "vm.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": out}, f)


@pytest.fixture
def logdir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("name", ["host.trace.json", "nested/host.pt.trace.json.gz"])
def test_op_stats_matches_jax_on_the_same_events(logdir, name):
    older = str(logdir / "port" / "old.trace.json")
    _torch_trace(older, [((0, 7), "kernel", "stale", 1, None, None)])
    os.utime(older, (time.time() - 60, time.time() - 60))
    _torch_trace(str(logdir / "port" / name), EVENTS)
    _xprof_trace(str(logdir / "jax"), EVENTS)
    got = prof.op_stats(str(logdir / "port"), steps=2, top=5)
    want = jprof.op_stats(str(logdir / "jax"), steps=2, top=5)
    assert got == want
    assert got["total_ms"] == 8.25
    memcpy, kernel, memset = got["by_category"]
    assert memcpy == {"category": "gpu_memcpy", "ms": 6.0, "pct": 72.7, "gb_accessed": 12.0, "gbps": 2000.0}
    assert (kernel["category"], kernel["ms"], kernel["gb_accessed"], kernel["gbps"]) == ("kernel", 2.0, 0.0, 0.0)
    assert (memset["ms"], memset["gb_accessed"], memset["gbps"]) == (0.25, 0.001, 4.0)
    assert got["top_ops"][1] == {"op": "mfcc_kernel", "ms": 2.0, "gb_accessed": 0.0,
                                 "long_name": "mfcc_kernel grid [96, 1, 1] block [256, 1, 1]"}
    assert prof.op_stats(str(logdir / "port"), steps=2, top=1)["top_ops"] == got["top_ops"][:1]


def test_op_stats_refuses_an_empty_directory_or_trace(logdir):
    with pytest.raises(FileNotFoundError):
        prof.op_stats(str(logdir))
    _torch_trace(str(logdir / "x.trace.json"), [])
    with pytest.raises(ValueError, match="no device events"):
        prof.op_stats(str(logdir))


def test_live_cpu_capture_reads_the_busiest_cpu_op_lane(logdir):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        x = torch.randn(128, 128)
        lin = torch.nn.Linear(128, 128)
        t0 = time.perf_counter()
        with prof.trace(str(logdir)) as p:
            for _ in range(3):
                lin(x).relu().sum().item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.set_num_threads(threads)
    assert isinstance(p, torch.profiler.profile)
    assert [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    stats = prof.op_stats(str(logdir), steps=3, top=3)
    assert set(stats) == {"total_ms", "by_category", "top_ops"}
    assert [c["category"] for c in stats["by_category"]] == ["cpu_op"]
    row = stats["by_category"][0]
    assert set(row) == {"category", "ms", "pct", "gb_accessed", "gbps"} and row["pct"] == 100.0
    assert row["gb_accessed"] == 0.0 and 0 < stats["total_ms"] <= wall_ms / 3
    ops = [op["op"] for op in stats["top_ops"]]
    assert "aten::linear" in ops and "aten::addmm" not in ops  # outermost ops only, each counted once
    assert all(set(op) == {"op", "ms", "gb_accessed", "long_name"} for op in stats["top_ops"])


def test_step_timer_counts_as_jax(monkeypatch):
    clock = [100.0]
    for mod in (prof, jprof):
        monkeypatch.setattr(mod, "time", SimpleNamespace(perf_counter=lambda: clock[0]))
    got, want = prof.StepTimer(clips_per_step=8, warmup=2), jprof.StepTimer(clips_per_step=8, warmup=2)
    for _ in range(4):
        assert (got.count, got.steps_timed, got.seconds) == (want.count, want.steps_timed, want.seconds)
        got.step()
        want.step()
        clock[0] += 0.5
    assert got.steps_timed == want.steps_timed == 2
    assert got.seconds == want.seconds == 1.5  # from the warmup step on
    assert (got.steps_per_sec, got.clips_per_sec) == (want.steps_per_sec, want.clips_per_sec) == (2 / 1.5, 16 / 1.5)
    t = prof.StepTimer(clips_per_step=8, warmup=1)
    for _ in range(3):
        t.step()
    assert t.steps_timed == 2 and t.clips_per_sec == 0.0  # no time has passed on the clock


def test_device_memory_stats_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof.device_memory_stats() == []
