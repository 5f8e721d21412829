"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. It
imports nothing of JAX. Phases, each fatal on failure:

1. build every kernel of ``acoustic_image_generation_tpu_torch/csrc`` with
   ``nvcc``, all at once, into ``build/aig_torch_kernels/``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and time kernel, plain version and a
   library yardstick with CUDA events;
3. serve full-width bf16 requests (ResNet50 3/4/6/3 + UNetAcResNet 1-skip
   VAE, random weights from a seed, 96 frames each) through
   ``GenerationService``, with the kernels' launch counts reset just before
   and read just after;
4. check the CUDA path against the CPU path (the plain versions, which the
   CPU tests hold against the JAX package) on a small f32 input;
5. print the card's name and power limit, one ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

f32 comparisons run with TF32 off for matmuls and cuDNN convolutions
(set in ``main``), so "f32" means IEEE f32 on both sides.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 96  # one request: 8 clips x 12 frames
REQUESTS = 4
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
MFCC_TOL = dict(rtol=2e-3, atol=2e-3)
CHAIN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PATH_TOL = 1e-3  # CUDA vs CPU serving output, f32, sigmoid scale


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, got, want, tol) -> float:
    """Max abs error; raise if any element misses ``atol + rtol*|want|``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    limit = tol["atol"] + tol["rtol"] * want.abs()
    bad = int((diff > limit).sum())
    err = float(diff.max())
    rel = float((diff / want.abs().clamp_min(1e-6)).max())
    log(f"check {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} tol={tol} bad={bad}")
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside {tol}")
    return err


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_mfcc(mk) -> dict:
    from acoustic_image_generation_tpu_torch.dsp.mfcc import device_constants

    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = []
    for n in (FRAMES, 1000, 5):
        x = torch.randint(-(2**15), 2**15, (n, 1024), generator=g, device="cuda").float()
        errs.append(compare(f"mfcc n={n}", mk.mfcc(x), mk.mfcc_plain(x), MFCC_TOL))
    x = torch.randint(-(2**15), 2**15, (FRAMES, 1024), generator=g, device="cuda").float()
    ms = time_ms(lambda: mk.mfcc(x))
    plain = time_ms(lambda: mk.mfcc_plain(x))
    consts = device_constants(x.device)
    nbytes = x.numel() * 4 + sum(c.numel() * 4 for c in consts) + FRAMES * 12 * 4
    cos_b, _, mel_b, dct_b = consts
    flops = FRAMES * (
        2 * 2 * cos_b.shape[0] * cos_b.shape[1]  # two DFT GEMMs
        + 3 * cos_b.shape[1]  # power
        + 2 * mel_b.numel() + 2 * dct_b.numel()
    )
    b, by = bound_ms(nbytes, flops, torch.float32)
    log(f"time mfcc n={FRAMES}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b:.4f} ms ({by}), "
        f"{flops / ms / 1e9:.3f} TFLOP/s")
    return dict(
        name="mfcc", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/mfcc.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_mfcc.py:86",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        # no single PyTorch call computes the MFCC; the plain version is
        # itself the torch.matmul chain
        library_ms=None,
    )


def chain_layers(task):
    """(name, input (N,H,W,Ci) shape, packed weights) of every conv chain
    the generator runs, at FRAMES frames."""
    gen = task.generator
    sizes = {"layer1": (36, 48), "layer2": (12, 16), "layer4": (12, 16), "layer5": (12, 16),
             "layer6": (36, 48), "layer7": (36, 48)}
    out = []
    for name, (h, w) in sizes.items():
        block = getattr(gen, name)
        convs = [getattr(block, f"conv_{i + 1}") for i in range(block.n)]
        ci = convs[0].weight.shape[0] // 9
        out.append((name, (FRAMES, h, w, ci), [c.weight for c in convs]))
    return out


def check_conv_chain(cc, task) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, flops=0.0, nbytes=0.0)
    err_main = 0.0
    for name, shape, ws in chain_layers(task):
        relu = (True,) * len(ws)
        # non-zero biases (init_params zeroes them) so the bias add is checked
        bs = [0.1 * torch.randn(w.shape[1], generator=g, device="cuda") for w in ws]
        for dt in (torch.bfloat16, torch.float32):
            x = torch.relu(torch.randn(shape, generator=g, device="cuda")).to(dt)
            wd = [w.to(dt) for w in ws]
            err = compare(f"conv_chain {name} {str(dt)[6:]} {tuple(shape)}",
                          cc.conv_chain(x, wd, bs, relu), cc.conv_chain_reference(x, wd, bs, relu),
                          CHAIN_TOL[dt])
            if dt != task.dtype:
                continue
            err_main = max(err_main, err)
            w_oihw = [cc.unpack_oihw(w).contiguous(memory_format=torch.channels_last) for w in wd]
            b_dt = [b.to(dt) for b in bs]

            def library(x=x, w_oihw=w_oihw, b_dt=b_dt):
                y = x.permute(0, 3, 1, 2)
                for w, b in zip(w_oihw, b_dt):
                    y = F.relu(F.conv2d(y, w, b, padding=1))
                return y

            ms = time_ms(lambda: cc.conv_chain(x, wd, bs, relu))
            plain = time_ms(lambda: cc.conv_chain_reference(x, wd, bs, relu))
            lib = time_ms(library)
            n, h, w_, _ = shape
            flops = sum(2 * n * h * w_ * wt.shape[0] * wt.shape[1] for wt in wd)
            item = dt.itemsize
            nbytes = (x.numel() + n * h * w_ * wd[-1].shape[1]) * item + sum(
                wt.numel() * item + b.numel() * 4 for wt, b in zip(wd, bs))
            b, by = bound_ms(nbytes, flops, dt)
            log(f"time conv_chain {name} {tuple(shape)} -> {wd[-1].shape[1]}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, cudnn {lib:.4f} ms, bound {b:.4f} ms ({by}), "
                f"{flops / 1e9:.2f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s")
            for k, v in dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, flops=flops,
                             nbytes=nbytes).items():
                tot[k] += v
    b, by = bound_ms(tot["nbytes"], tot["flops"], task.dtype)
    log(f"time conv_chain all chains of one {FRAMES}-frame request: kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, cudnn {tot['library_ms']:.4f} ms, bound {b:.4f} ms "
        f"({by}), {tot['flops'] / 1e9:.1f} GFLOP")
    return dict(
        name="conv_chain", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/conv_chain.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_conv.py:388",
        max_abs_err=err_main, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
        library_ms=tot["library_ms"],
    )


def request(rng, n=FRAMES):
    audio = rng.integers(-(2**15), 2**15, (n, 1024)).astype(np.int32)
    video = rng.integers(0, 256, (n, 224, 298, 3)).astype(np.uint8)
    return audio, video


def serve(service, mk, cc) -> tuple[dict, list]:
    rng = np.random.default_rng(SEED)
    reqs = [request(rng) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.mfcc.launches = 0
    cc.conv_chain.launches = 0
    times = []
    for i, (audio, video) in enumerate(reqs):
        t0 = time.perf_counter()
        gen, energy = service(audio, video, seed=SEED + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if gen.shape != (FRAMES, 36, 48, 12) or energy.shape != (FRAMES, 36, 48):
            raise AssertionError(f"request {i}: shapes {tuple(gen.shape)}, {tuple(energy.shape)}")
        if not (torch.isfinite(gen).all() and gen.min() >= 0 and gen.max() <= 1):
            raise AssertionError(f"request {i}: output not finite in [0, 1]")
        if not torch.isfinite(energy).all():
            raise AssertionError(f"request {i}: energy not finite")
        log(f"request {i}: {FRAMES} frames, {times[-1]:.2f} ms, output range "
            f"[{float(gen.min()):.4f}, {float(gen.max()):.4f}], energy mean {float(energy.mean()):.4e}")
    launches = {"mfcc": mk.mfcc.launches, "conv_chain": cc.conv_chain.launches}
    per_request = {"mfcc": 1, "conv_chain": 12}  # 1 frontend launch; 6 chains x 2 convs
    log(f"launches over {REQUESTS} requests: {launches} (expected {per_request} per request)")
    for k, v in per_request.items():
        if launches[k] != v * REQUESTS:
            raise AssertionError(f"{k}: {launches[k]} launches, expected {v * REQUESTS}")
    steady = statistics.median(times[1:])
    log(f"serving: first request {times[0]:.2f} ms, median of the next {REQUESTS - 1} "
        f"{steady:.2f} ms, {FRAMES / 12 / steady * 1e3:.1f} clips/s ({FRAMES / steady * 1e3:.0f} frames/s), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, reqs


def stage_breakdown(task, audio, video) -> None:
    """Device time of each stage of one request, by CUDA events."""
    from acoustic_image_generation_tpu_torch.data.preprocess import preprocess_batch, tile_mfccmap
    from acoustic_image_generation_tpu_torch.dsp.energy import find_logen

    names = ("upload", "frontend", "trunk", "generator", "energy")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one reported
            torch.cuda.synchronize()
            ev[0].record()
            a = torch.from_numpy(audio).cuda()
            v = torch.from_numpy(video).cuda()
            ev[1].record()
            batch = preprocess_batch(a, v)
            ev[2].record()
            feat = task.resnet(batch.video, mode="full")
            ev[3].record()
            out = task.generator(tile_mfccmap(batch.mfcc).to(task.dtype), feat, generator=g)
            ev[4].record()
            find_logen(out.output.float())
            ev[5].record()
            torch.cuda.synchronize()
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    total = ev[0].elapsed_time(ev[-1])
    log("stages of one request (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {total:.3f}")


def profile_request(service, audio, video) -> None:
    """Device time by kernel for one request under torch.profiler, and the
    device's idle share of the request's wall time (profiling included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service(audio, video, seed=SEED)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile of one request: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle {100 * (1 - busy / wall):.1f}%, {len(kernels)} distinct kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:8.3f} ms {100 * ms / busy:5.1f}% x{e.count:<4d} {e.key[:90]}")


def randomize_biases(task, seed: int) -> None:
    """Non-zero biases everywhere (``init_params`` zeroes the generator's),
    drawn on the CPU so that every device gets the same ones."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in task.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))


def check_against_cpu() -> None:
    """The same f32 weights, non-zero biases included, and noise through the
    CUDA path (kernels) and the CPU path (plain versions) on a small input."""
    from acoustic_image_generation_tpu_torch.serving import GenerationService
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    cfg = GenerationConfig(compute_dtype="float32")
    rng = np.random.default_rng(SEED + 7)
    audio, video = request(rng, n=2)
    eps = rng.standard_normal((2, 150)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        task = GenerationTask(cfg, device=dev).init_params(SEED)
        randomize_biases(task, SEED + 8)
        gen, energy = GenerationService(task)(audio, video, seed=SEED, eps=eps)
        outs.append((gen.cpu(), energy.cpu()))
    err = float((outs[0][0] - outs[1][0]).abs().max())
    rel_e = float(((outs[0][1] - outs[1][1]).abs() / outs[1][1].abs()).max())
    log(f"check serving f32 cuda vs cpu (2 frames): max_abs_err={err:.3e} (tol {PATH_TOL}), "
        f"energy max_rel_err={rel_e:.3e}")
    if not err <= PATH_TOL:
        raise AssertionError(f"CUDA and CPU serving paths differ by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # IEEE f32 wherever f32 is compared: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from acoustic_image_generation_tpu_torch.ops import build
    from acoustic_image_generation_tpu_torch.ops import conv_chain as cc
    from acoustic_image_generation_tpu_torch.ops import mfcc_kernel as mk
    from acoustic_image_generation_tpu_torch.serving import GenerationService
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    report = build.build()
    for name, (secs, text) in report.items():
        log(f"build {name}: {secs:.2f} s")
        for fn, regs in re.findall(r"entry function '(\w+)'.*?(Used \d+ registers[^\n]*)", text, re.S):
            log(f"  {fn}: {regs}")
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(report)} libraries")

    task = GenerationTask(GenerationConfig(), device="cuda").init_params(SEED)
    kernels = [check_mfcc(mk), check_conv_chain(cc, task)]

    service = GenerationService(task)
    launches, reqs = serve(service, mk, cc)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    stage_breakdown(task, *reqs[0])
    profile_request(service, *reqs[0])
    check_against_cpu()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: item[k] for k in keys} for item in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
