"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. It
imports nothing of JAX. Phases, each fatal on failure:

1. build every kernel of ``acoustic_image_generation_tpu_torch/csrc`` with
   ``nvcc``, all at once, into ``build/aig_torch_kernels/``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it (serving: 96 frames; training: 768 frames; the
   f32 backward against a float64 witness), and time kernel, plain version
   and a library yardstick with CUDA events;
3. serve full-width bf16 requests (ResNet50 3/4/6/3 + UNetAcResNet 1-skip
   VAE, random weights from the seed, 96 frames each) through
   ``GenerationService``, with the kernels' launch counts reset just before
   and read just after;
4. check the CUDA serving path against the CPU path (the plain versions,
   which the CPU tests hold against the JAX package) on a small f32 input;
5. train: full width, bf16, 64 clips x 12 frames per step on one fixed
   synthetic batch through ``Trainer.train_step``, with the launch counts
   reset just before and read just after; step times, peak memory, a stage
   breakdown and one profiled step; the loss falls, the trunk stays
   bit-frozen, the generator, ``conv_map`` and the trunk's BN statistics
   move;
6. two f32 train steps on 2 frames on CUDA and on the CPU, from the same
   weights and noise;
7. the trunk's train-mode forward with ``fused_bn_stats`` (the
   ``matmul_stats`` kernel) against the same trunk without it, 96 frames,
   and each bf16 fused unit against its plain version;
8. print the card's name and power limit, one ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

f32 comparisons run with TF32 off for matmuls and cuDNN convolutions
(set in ``main``), so "f32" means IEEE f32 on both sides.
"""

from __future__ import annotations

import argparse
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
SEED = 0  # set from --seed in main
TRAIN_CLIPS = 64  # the JAX package's uncached train-step batch (bench.py)
TRAIN_FRAMES = 12 * TRAIN_CLIPS
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
MFCC_TOL = dict(rtol=2e-3, atol=2e-3)
CHAIN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
PATH_TOL = 1e-3  # CUDA vs CPU serving output, f32, sigmoid scale
# Backward grads, as the largest error over each tensor's largest entry,
# per tensor kind. bf16 against the plain backward (f32 arithmetic): a
# cotangent that differs in its last f32 bits can round to another bf16
# operand (readings on an H100 at 768 frames: dx 3.3e-3, dW 2.2e-4, db 1.5e-6).
# f32 against a float64 witness (the plain backward in f64 on the same
# operands): the kernels' IEEE f32 sums, each weight-grad slice 2048 pixels
# long (readings: dx 1.3e-6, dW 1.5e-6, db 1.1e-6; cuDNN's own f32 dW
# reads 1.5e-4). Each limit must stay below what a TF32 run (cuDNN, TF32
# on) reads: dx 3.9e-4, dW 9.2e-4 at the least.
GRAD_TOL = {torch.bfloat16: dict(dx=1e-2, dW=1e-3, db=1e-5),
            torch.float32: dict(dx=1e-5, dW=1e-5, db=1e-5)}


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


def chain_layers(task, frames=FRAMES):
    """(name, input (N,H,W,Ci) shape, packed f32 master weights) of every
    conv chain the generator runs, at ``frames`` frames."""
    gen = task.generator
    sizes = {"layer1": (36, 48), "layer2": (12, 16), "layer4": (12, 16), "layer5": (12, 16),
             "layer6": (36, 48), "layer7": (36, 48)}
    out = []
    for name, (h, w) in sizes.items():
        block = getattr(gen, name)
        convs = [getattr(block, f"conv_{i + 1}") for i in range(block.n)]
        ci = convs[0].weight.shape[0] // 9
        out.append((name, (frames, h, w, ci), [c.weight.detach() for c in convs]))
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


def rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    return abs_err(got, want) / float(want.float().abs().max().clamp_min(1e-30))


def abs_err(got, want) -> float:
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    return float((got - want).abs().max())


def grad_errors(got, want, needs_dx) -> dict:
    """Relative error (``rel_err``) of every grad of a chain's backward."""
    k = len(want[1])
    pairs = {f"dW{i}": (got[1][i], want[1][i]) for i in range(k)}
    pairs.update({f"db{i}": (got[2][i], want[2][i]) for i in range(k)})
    if needs_dx:
        pairs["dx"] = (got[0], want[0])
    return {name: rel_err(*pair) for name, pair in pairs.items()}


def worst_by_kind(errs: dict) -> dict:
    """{"dW": .., "db": .., "dx": ..}: the largest error of each kind."""
    out = {}
    for name, e in errs.items():
        out[name[:2]] = max(out.get(name[:2], 0.0), e)
    return out


def check_conv_chain_backward(cc, task) -> dict:
    """The backward kernels at the training shapes, both dtypes, non-zero
    biases: bf16 against the plain backward, f32 against a float64 witness
    beside cuDNN's f32 and TF32 readings of the same grads; times in the
    task's dtype against autograd's backward of the cuDNN chain."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    err_main = 0.0
    for name, shape, ws in chain_layers(task, TRAIN_FRAMES):
        relu = (True,) * len(ws)
        needs_dx = name != "layer1"  # layer1's input, the MFCC map, needs no grad
        bs = [0.1 * torch.randn(w.shape[1], generator=g, device="cuda") for w in ws]
        for dt in (torch.bfloat16, torch.float32):
            x = torch.relu(torch.randn(shape, generator=g, device="cuda")).to(dt)
            wd = [w.to(dt) for w in ws]
            acts = cc._forward_cuda(x, wd, bs, relu)
            gy = torch.randn(acts[-1].shape, generator=g, device="cuda").to(dt)
            args = (x, acts, wd, gy, relu, needs_dx)
            got = cc.conv_chain_backward(*args)
            tol = GRAD_TOL[dt]
            if dt == torch.bfloat16:
                want = cc.conv_chain_backward_reference(*args)
                errs = grad_errors(got, want, needs_dx)
                against = "plain backward"
            else:
                want = cc.conv_chain_backward_reference(*args, acc=torch.float64)
                errs = grad_errors(got, want, needs_dx)
                cudnn = worst_by_kind(grad_errors(cc.conv_chain_backward_reference(*args), want, needs_dx))
                torch.backends.cudnn.allow_tf32 = True
                try:
                    tf32 = worst_by_kind(grad_errors(cc.conv_chain_backward_reference(*args), want, needs_dx))
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                against = "float64 witness"
                log(f"  witness readings {name} float32: cuDNN f32 "
                    + ", ".join(f"{k} {v:.2e}" for k, v in cudnn.items()) + "; cuDNN TF32 "
                    + ", ".join(f"{k} {v:.2e}" for k, v in tf32.items()))
                for kind in ("dW", "dx"):
                    if kind in tf32 and not tol[kind] < tf32[kind]:
                        raise AssertionError(f"conv_chain_backward {name}: the f32 {kind} limit {tol[kind]} "
                                             f"does not exclude a TF32 run ({tf32[kind]:.2e})")
            worst = worst_by_kind(errs)
            log(f"check conv_chain_backward {name} {str(dt)[6:]} {tuple(shape)} against the {against}: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {tol})")
            bad = [k for k, v in worst.items() if v > tol[k]]
            if bad:
                raise AssertionError(f"conv_chain_backward {name} {dt}: {bad} outside {tol}")
            if dt != task.dtype:
                del got, want
                continue
            err_main = max(err_main, abs_err(got[0], want[0]) if needs_dx else 0.0,
                           *(abs_err(a, b) for a, b in zip(got[1] + got[2], want[1] + want[2])))
            del got, want
            with torch.enable_grad():  # the yardstick's graph: autograd over cuDNN
                xl = x.permute(0, 3, 1, 2).detach().requires_grad_(needs_dx)
                wl = [cc.unpack_oihw(w).contiguous(memory_format=torch.channels_last).requires_grad_()
                      for w in wd]
                bl = [b.to(dt).requires_grad_() for b in bs]
                y = xl
                for w, b in zip(wl, bl):
                    y = F.relu(F.conv2d(y, w, b, padding=1))
            inputs = ([xl] if needs_dx else []) + wl + bl
            gl = gy.permute(0, 3, 1, 2)
            ms = time_ms(lambda: cc.conv_chain_backward(x, acts, wd, gy, relu, needs_dx), iters=10)
            plain = time_ms(lambda: cc.conv_chain_backward_reference(x, acts, wd, gy, relu, needs_dx),
                            iters=5, warmup=1)
            lib = time_ms(lambda: torch.autograd.grad(y, inputs, gl, retain_graph=True), iters=10)
            n, h, w_, _ = shape
            chans = [shape[-1]] + [w.shape[1] for w in wd]
            macs = [n * h * w_ * 9 * ci * co for ci, co in zip(chans[:-1], chans[1:])]
            flops = sum(2 * m * (2 if (i > 0 or needs_dx) else 1) for i, m in enumerate(macs))
            item = dt.itemsize
            nbytes = (x.numel() + sum(a.numel() for a in acts) + gy.numel()) * item + sum(
                w.numel() * (item + 4) + w.shape[1] * 4 for w in wd) + (x.numel() * item if needs_dx else 0)
            b, by = bound_ms(nbytes, flops, dt)
            log(f"time conv_chain_backward {name} {tuple(shape)}: kernels {ms:.3f} ms, plain {plain:.3f} ms, "
                f"cudnn autograd {lib:.3f} ms, bound {b:.4f} ms ({by}), {flops / 1e9:.1f} GFLOP, "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
            for k, v in dict(ms=ms, plain_ms=plain, library_ms=lib, flops=flops, nbytes=nbytes).items():
                tot[k] += v
            del y, inputs, xl, wl, bl
    b, by = bound_ms(tot["nbytes"], tot["flops"], task.dtype)
    log(f"time conv_chain_backward all chains of one {TRAIN_FRAMES}-frame step: kernels {tot['ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms, cudnn autograd {tot['library_ms']:.3f} ms, bound {b:.4f} ms "
        f"({by}), {tot['flops'] / 1e9:.1f} GFLOP")
    return dict(
        name="conv_chain_backward", route="cuda",
        source="acoustic_image_generation_tpu_torch/csrc/conv_chain.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_conv.py:443",
        max_abs_err=err_main, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
        library_ms=tot["library_ms"],
    )


# (name, rows per frame, K, N) of three of the trunk's 1x1 stride-1 convs
STATS_SHAPES = (
    ("block1_unit_1.conv1", 55 * 74, 64, 64),
    ("block3_unit_1.conv3", 28 * 37, 256, 1024),
    ("block4_unit_1.shortcut", 14 * 19, 1024, 2048),
)


def check_matmul_stats(cs, task) -> dict:
    """The kernel against its plain version at three trunk shapes at the
    training batch, both dtypes; times in the task's dtype against
    ``torch.matmul`` followed by the two sums."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    err_main = 0.0
    for name, rows, k, n in STATS_SHAPES:
        m = TRAIN_FRAMES * rows
        for dt in (torch.bfloat16, torch.float32):
            x = torch.relu(torch.randn((m, k), generator=g, device="cuda")).to(dt)
            w = (torch.randn((k, n), generator=g, device="cuda") / k**0.5).to(dt)
            y, s, ss = cs.matmul_stats(x, w)
            wy, ws, wss = cs.matmul_stats_reference(x, w)
            err = compare(f"matmul_stats {name} y {str(dt)[6:]} ({m},{k})@({k},{n})", y, wy, CHAIN_TOL[dt])
            e_s, e_ss = rel_err(s, ws), rel_err(ss, wss)
            log(f"check matmul_stats {name} sums {str(dt)[6:]}: relative errors sum {e_s:.2e}, "
                f"sumsq {e_ss:.2e} (tol 1e-4)")
            if max(e_s, e_ss) > 1e-4:
                raise AssertionError(f"matmul_stats {name} {dt}: sums off by {max(e_s, e_ss)}")
            del y, s, ss, wy, ws, wss
            if dt != task.dtype:
                continue
            err_main = max(err_main, err)

            def library(x=x, w=w):
                y = torch.matmul(x, w)
                return y, y.sum(0, dtype=torch.float32), (y * y).sum(0, dtype=torch.float32)

            ms = time_ms(lambda: cs.matmul_stats(x, w))
            plain = time_ms(lambda: cs.matmul_stats_reference(x, w), iters=5, warmup=1)
            lib = time_ms(library)
            flops = 2 * m * k * n + 3 * m * n
            nbytes = (m * k + k * n + m * n) * dt.itemsize + 2 * n * 4
            b, by = bound_ms(nbytes, flops, dt)
            log(f"time matmul_stats {name} ({m},{k})@({k},{n}): kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                f"matmul+sums {lib:.3f} ms, bound {b:.4f} ms ({by}), {flops / ms / 1e9:.1f} TFLOP/s")
            for key, v in dict(ms=ms, plain_ms=plain, library_ms=lib, flops=flops, nbytes=nbytes).items():
                tot[key] += v
    b, by = bound_ms(tot["nbytes"], tot["flops"], task.dtype)
    return dict(
        name="matmul_stats", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/matmul_stats.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_conv_stats.py:114",
        max_abs_err=err_main, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
        library_ms=tot["library_ms"],
    )


def train_batch(rng, clips, frames_per_clip=12):
    """One synthetic batch of raw clips, as the JAX bench makes it."""
    f = (clips, frames_per_clip)
    return dict(
        acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
        audio=rng.integers(-(2**15), 2**15, (*f, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
    )


def train(kernels_mod) -> dict:
    """TRAIN_STEPS full-width bf16 train steps on one fixed batch; returns
    the launch counts of the steps."""
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    mk, cc, _ = kernels_mod
    task = GenerationTask(GenerationConfig(seed=SEED), device="cuda").init_params(SEED)
    trainer = Trainer(task)
    state = trainer.init_state()
    raw = train_batch(np.random.default_rng(SEED + 4), TRAIN_CLIPS)
    labels = task.param_labels()
    before = {n: p.detach().clone() for n, p in task.named_parameters()}
    stats_before = task.resnet.block1_unit_1.conv1.bn.running_mean.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.mfcc.launches = cc.conv_chain.launches = cc.conv_chain_backward.launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, raw)
        losses.append(float(metrics["loss"]))  # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        log(f"train step {state.step}: {times[-1]:.1f} ms, "
            + ", ".join(f"{k} {float(v):.6g}" for k, v in metrics.items()))
    launches = {"mfcc": mk.mfcc.launches, "conv_chain": cc.conv_chain.launches,
                "conv_chain_backward": cc.conv_chain_backward.launches}
    per_step = {"mfcc": 1, "conv_chain": 12, "conv_chain_backward": 12 + 12 + 11}
    log(f"launches over {TRAIN_STEPS} train steps: {launches} (expected {per_step} per step: "
        "conv_chain_backward = 12 gate + 12 weight-grad + 11 data-grad, layer1's input needs none)")
    for k, v in per_step.items():
        if launches[k] != v * TRAIN_STEPS:
            raise AssertionError(f"train {k}: {launches[k]} launches, expected {v * TRAIN_STEPS}")
    steady = statistics.median(times[1:])
    log(f"train: {TRAIN_CLIPS} clips x 12 frames per step, first step {times[0]:.1f} ms, median of the "
        f"next {TRAIN_STEPS - 1} {steady:.1f} ms, {TRAIN_CLIPS / steady * 1e3:.1f} clips/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite or not lower after the last step")
    for n, p in task.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if labels[n] == "frozen" and not same:
            raise AssertionError(f"frozen parameter {n} changed")
        if labels[n] == "train" and same:
            raise AssertionError(f"trained parameter {n} did not change")
    if torch.equal(task.resnet.block1_unit_1.conv1.bn.running_mean, stats_before):
        raise AssertionError("the trunk's BN running statistics did not change")
    log(f"train checks: losses {losses[0]:.6g} -> {losses[-1]:.6g}, trunk bit-frozen, "
        f"{sum(l == 'train' for l in labels.values())} trained tensors changed, trunk BN statistics moved")
    train_stages(trainer, state, raw)
    profile_step(trainer, state, raw)
    return launches


def train_stages(trainer, state, raw) -> None:
    """Device time of each stage of one train step, by CUDA events. The
    same calls as ``Trainer.train_step``, split where the events go."""
    from acoustic_image_generation_tpu_torch.train.generation import no_tf32
    from acoustic_image_generation_tpu_torch.train.trainer import step_generator

    task = trainer.task
    names = ("prepare", "trunk", "generator forward", "loss", "backward", "optimizer")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with no_tf32():
        torch.cuda.synchronize()
        ev[0].record()
        batch = trainer._prepare(raw)
        ev[1].record()
        feat = task.resnet(batch.video, mode="trunk", train=True)
        ev[2].record()
        out = task._forward(batch.mfcc, None, train=True, trunk_feat=feat,
                            generator=step_generator(SEED, state.step, "cuda"))
        ev[3].record()
        total, _ = task.objective(out, batch)
        ev[4].record()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[5].record()
        state.optimizer.step()
        ev[6].record()
        torch.cuda.synchronize()
    state.step += 1
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    log("stages of one train step (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {ev[0].elapsed_time(ev[-1]):.3f}")


def profile_step(trainer, state, raw) -> None:
    """Device time by kernel for one train step under torch.profiler, and
    the device's idle share of the step's wall time (profiling included)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, raw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile of one train step: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
        f"idle {100 * (1 - busy / wall):.1f}%, {len(kernels)} distinct kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{e.count:<5d} {e.key[:90]}")


def check_train_against_cpu() -> None:
    """Two f32 train steps on 2 frames, on CUDA (kernels) and on the CPU
    (plain versions), from the same weights, non-zero biases and noise.
    Losses within 1e-4 relative; parameter updates held to lr, since Adam
    moves an entry whose gradient is at rounding-noise level by a full lr
    with whatever sign the noise gives it: every entry within 2 lr, each
    tensor's update within 10% in L2 norm; the trunk bit-frozen on both."""
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    cfg = GenerationConfig(compute_dtype="float32", seed=SEED)
    raw = train_batch(np.random.default_rng(SEED + 9), 1, frames_per_clip=2)
    eps = np.random.default_rng(SEED + 10).standard_normal((2, 2, 150)).astype(np.float32)
    runs = []
    for dev in ("cuda", "cpu"):
        task = GenerationTask(cfg, device=dev).init_params(SEED)
        randomize_biases(task, SEED + 8)
        init = {n: p.detach().cpu().clone() for n, p in task.named_parameters()}
        trainer = Trainer(task)
        state = trainer.init_state()
        losses = [float(trainer.train_step(state, raw, eps=e)[1]["loss"]) for e in eps]
        runs.append((losses, {n: p.detach().cpu() for n, p in task.named_parameters()}))
    labels = task.param_labels()
    (l_cuda, p_cuda), (l_cpu, p_cpu) = runs
    lr = cfg.learning_rate
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_cuda, l_cpu))
    worst_entry = worst_norm = 0.0
    for n, want in p_cpu.items():
        if labels[n] == "frozen":
            if not (torch.equal(p_cuda[n], init[n]) and torch.equal(want, init[n])):
                raise AssertionError(f"frozen parameter {n} changed")
            continue
        d_cuda, d_cpu = p_cuda[n] - init[n], want - init[n]
        gap = (d_cuda - d_cpu).abs()
        worst_entry = max(worst_entry, float(gap.max()) / lr)
        worst_norm = max(worst_norm, float(gap.norm() / d_cpu.norm().clamp_min(1e-30)))
    log(f"check train f32 cuda vs cpu (2 frames, 2 steps): losses {l_cuda} vs {l_cpu}, relative "
        f"error {loss_err:.2e} (tol 1e-4); worst update gap {worst_entry:.3f} lr (tol 2), worst "
        f"tensor update gap {worst_norm:.3e} in L2 (tol 0.1)")
    if not (loss_err <= 1e-4 and worst_entry <= 2 and worst_norm <= 0.1):
        raise AssertionError("CUDA and CPU train steps differ")


def check_trunk(fused: bool, dtype):
    """Full-width ResNet50 on the card with ``init_params``' distributions
    from the seed, and BN scales, shifts and running statistics drawn away
    from their initial values, so that each of them is exercised."""
    from acoustic_image_generation_tpu_torch.models.resnet import BatchNorm, ResNet50

    resnet = ResNet50(fused_bn_stats=fused, device="cuda", dtype=dtype)
    g = torch.Generator().manual_seed(SEED)
    for m in resnet.modules():
        if m is not resnet and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    g = torch.Generator().manual_seed(SEED + 6)
    with torch.no_grad():
        for m in resnet.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
                m.bias.copy_(0.05 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return resnet


def check_fused_units(cs, inputs) -> None:
    """Each fused unit of the bf16 trunk (conv, BN on the batch statistics,
    ReLU) on the input the trunk gave it: the port's module on the card
    (the kernel and ``BatchNorm.forward_stats``) against the plain version
    with JAX's ``_TrainBN`` written out (the batch mean subtracted in bf16).

    The kernel's ``y`` is held to one bf16 rounding of the plain ``y``, its
    batch mean and variance within 1e-3 of their largest entry: the
    variance is the difference of two f32 sums over up to 0.4 M rows, which
    magnifies their rounding where the mean is large (1.5e-4 measured).
    The unit's output may differ by what those gaps carry through BN: one
    bf16 rounding (2^-7 relative at most) each of ``y``, the mean, the scale
    ``inv`` and the output on either side, and the relative gap ``dinv``
    between the two sides' ``rsqrt(var + eps)``."""
    bf16 = torch.bfloat16
    u = 2.0**-7
    worst_y = worst_stats = worst_unit = 0.0
    for m, x in inputs:
        w = m.weight.to(m.dtype)
        w = w.reshape(w.shape[0], -1).t()
        y, mean, var = cs.conv1x1_batch_stats(x, w)
        wy, s, ss = cs.matmul_stats_reference(x.reshape(-1, x.shape[-1]), w)
        rows = wy.shape[0]
        wmean = s / rows
        wvar = torch.clamp_min(ss / rows - wmean * wmean, 0.0)
        diff = (y.reshape(wy.shape).float() - wy.float()).abs()
        tol = CHAIN_TOL[bf16]
        if bool((diff > tol["atol"] + tol["rtol"] * wy.float().abs()).any()):
            raise AssertionError(f"matmul_stats y of a fused trunk conv {tuple(x.shape)} off")
        worst_y = max(worst_y, float(diff.max()))
        worst_stats = max(worst_stats, rel_err(mean, wmean), rel_err(var, wvar))

        got = m(x, train=True).reshape(wy.shape).float()
        inv = m.bn.weight * torch.rsqrt(wvar + m.bn.eps)
        want = (wy - wmean.to(bf16)) * inv.to(bf16) + m.bn.bias.to(bf16)
        want = (torch.relu(want) if m.relu else want).float()
        dinv = (torch.rsqrt(var + m.bn.eps) / torch.rsqrt(wvar + m.bn.eps) - 1).abs()
        yf = wy.float()
        limit = (u * (2 * (yf.abs() + wmean.abs()) * inv.abs() + 2 * want.abs())
                 + (yf - wmean).abs() * inv.abs() * (2 * u + dinv))
        ratio = float(((got - want).abs() / limit.clamp_min(1e-30)).max())
        worst_unit = max(worst_unit, ratio)
        if ratio > 1:
            raise AssertionError(f"fused unit {tuple(x.shape)} -> {m.weight.shape[0]}: output outside "
                                 f"its bf16 bound ({ratio:.3f} of it)")
    log(f"check the trunk's {len(inputs)} fused units bf16 on their trunk inputs: kernel y max_abs_err "
        f"{worst_y:.3e} (tol {CHAIN_TOL[bf16]}), batch mean and variance worst {worst_stats:.2e} of "
        f"their largest (tol 1e-3); unit output against the plain version with JAX's BN, worst "
        f"{worst_unit:.3f} of its bf16 bound (tol 1)")
    if worst_stats > 1e-3:
        raise AssertionError(f"fused conv batch statistics off by {worst_stats}")


def check_fused_bn_stats(cs) -> int:
    """The trunk's train-mode forward with ``fused_bn_stats`` against the
    same trunk without it, full width, FRAMES frames, from the same weights;
    returns the bf16 run's ``matmul_stats`` launches.

    The two sum in other orders, and through the trunk's 53 train-mode BNs
    any difference grows steadily: in f32 from 2e-5 of the largest value
    after the first unit to 8e-4 at ``conv_map`` (measured at 8 frames on an
    H100). So f32 holds the output within 2e-2 of its largest entry and the
    batch statistics (the running-average updates undone) within 2e-2 of
    each one's largest. In bf16 the fused BN subtracts the batch mean in
    bf16, as JAX's ``_TrainBN`` does, where the plain BN works in f32, and
    the gap at the output is of the order of the output itself: it is
    logged, and bf16 is held unit by unit (``check_fused_units``)."""
    from acoustic_image_generation_tpu_torch.models.resnet import BN_MOMENTUM

    video = torch.rand((FRAMES, 224, 298, 3), generator=torch.Generator(device="cuda").manual_seed(SEED + 5),
                       device="cuda")
    launches = 0
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for fused in (False, True):
            resnet = check_trunk(fused, dtype)
            before = {n: b.clone() for n, b in resnet.named_buffers()}
            inputs = []
            hooks = [m.register_forward_pre_hook(lambda m, args: inputs.append((m, args[0])))
                     for m in resnet.modules()
                     if dtype == torch.bfloat16 and getattr(m, "fused_stats", False)]
            with torch.no_grad():
                torch.cuda.synchronize()
                cs.matmul_stats.launches = 0
                out = resnet(video, mode="full", train=True)
                torch.cuda.synchronize()
                n = cs.matmul_stats.launches
            for h in hooks:
                h.remove()
            batch_stats = {k: (b - BN_MOMENTUM * before[k]) / (1 - BN_MOMENTUM)
                           for k, b in resnet.named_buffers()}
            runs[fused] = (out, batch_stats, inputs)
        log(f"fused_bn_stats trunk {str(dtype)[6:]}, {FRAMES} frames: {n} matmul_stats launches (expected 36)")
        if n != 36:
            raise AssertionError(f"fused_bn_stats: {n} matmul_stats launches, expected 36")
        (want, want_stats, _), (got, got_stats, inputs) = runs[False], runs[True]
        out_err = rel_err(got, want)
        stats_err = max(rel_err(got_stats[k], v) for k, v in want_stats.items())
        log(f"fused_bn_stats vs plain trunk {str(dtype)[6:]}: output {out_err:.2e} of the largest output, "
            f"batch statistics worst {stats_err:.2e} of their largest")
        if dtype == torch.float32:
            if not (out_err <= 2e-2 and stats_err <= 2e-2):
                raise AssertionError("fused_bn_stats f32 trunk differs from the plain trunk")
            continue
        launches = n
        with torch.no_grad():
            check_fused_units(cs, inputs)
        del runs, inputs
    return launches


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
    global SEED
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=SEED, help="seed of the weights and the data")
    SEED = parser.parse_args().seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # IEEE f32 wherever f32 is compared: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from acoustic_image_generation_tpu_torch.ops import build
    from acoustic_image_generation_tpu_torch.ops import conv_chain as cc
    from acoustic_image_generation_tpu_torch.ops import conv_stats as cs
    from acoustic_image_generation_tpu_torch.ops import mfcc_kernel as mk
    from acoustic_image_generation_tpu_torch.serving import GenerationService
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, seed {SEED}")
    t0 = time.perf_counter()
    report = build.build()
    for name, (secs, text) in report.items():
        log(f"build {name}: {secs:.2f} s")
        for fn, regs in re.findall(r"entry function '(\w+)'.*?(Used \d+ registers[^\n]*)", text, re.S):
            log(f"  {fn}: {regs}")
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(report)} libraries")

    task = GenerationTask(GenerationConfig(), device="cuda").init_params(SEED)
    with torch.no_grad():
        kernels = [check_mfcc(mk), check_conv_chain(cc, task), check_conv_chain_backward(cc, task),
                   check_matmul_stats(cs, task)]
    torch.cuda.empty_cache()

    phase = time.perf_counter()
    service = GenerationService(task)
    launches, reqs = serve(service, mk, cc)
    stage_breakdown(task, *reqs[0])
    profile_request(service, *reqs[0])
    check_against_cpu()
    del service, task, reqs
    torch.cuda.empty_cache()
    log(f"phase serving: {time.perf_counter() - phase:.1f} s")

    phase = time.perf_counter()
    launches.update(conv_chain_backward=train((mk, cc, cs))["conv_chain_backward"])
    torch.cuda.empty_cache()
    check_train_against_cpu()
    log(f"phase training: {time.perf_counter() - phase:.1f} s")
    phase = time.perf_counter()
    launches["matmul_stats"] = check_fused_bn_stats(cs)
    log(f"phase fused_bn_stats: {time.perf_counter() - phase:.1f} s")
    for k in kernels:
        k["launches"] = launches[k["name"]]

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
