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
   and a library yardstick with CUDA events; the ``conv_chain`` backward
   also launch by launch (gate, weight grad, data grad of each layer), and
   its channel padding (133 -> 136) is checked for leaks;
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
8. the int8 frozen trunk (BN folded, W8A8, ``fused_qgemm``): the trunk on
   the card at 96 frames, fused (``qgemm_s8``, checked in phase 2 at the 18
   shapes of its 36 launches, at 96 and 768 frames) against unfused, CUDA
   against the CPU, int8 against the bf16 eval trunk; four int8 requests
   through ``GenerationService`` (calibrated from the first) and five int8
   train steps (calibrated from the first batch) with launch counts, beside
   the bf16 requests of phase 3 and five bf16 steps with the same frozen
   trunk;
9. the embedding family (three VAEs aligned by a batch-hard triplet
   loss): the ``stft`` kernel against its plain version at 8 and 32
   seconds (checked with phase 2's kernels); four full-width bf16 requests
   of 96 frames (8 seconds) through ``EmbeddingService`` with launch counts,
   a stage breakdown and one profiled request, and a CUDA-vs-CPU f32 check;
   five full-width bf16 train steps of 32 clips x 12 frames (the JAX
   bench's embed batch) with launch counts, a stage breakdown and one
   profiled step, then two f32 steps on CUDA against the CPU;
10. print the card's name and power limit, one ``{"kernels": [...]}`` line,
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}  # dense, no TF32
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
# qgemm_s8 against its plain version: JAX's bound for its kernel against the
# unfused epilogue (tests/test_pallas_qgemm.py), at most one int8 quantum on
# under 1% of the entries; fewer than 5% of the outputs may clip, so that
# the comparison is not of saturated values. The int8 trunk on the card
# against the CPU (the same program, kernels against plain versions): JAX's
# bound between its fused and unfused trunks (tests/test_quant.py, four
# units), relative error under 0.05 and at most 8 quanta of the last site.
# Fused against unfused at full depth: the two programs round in another
# order at every one of the 16 units, and the gap grows with depth (on the
# CPU, 2 frames: 4.6e-3 over 4 units, 9.2e-3 over 6, 4.83e-2 and 9 quanta
# over 16, outside JAX's four-unit bound); held to what quantization itself
# may cost against the f32 trunk (tests/test_quant.py): relative 0.1, and
# 16 quanta.
QGEMM_TOL = dict(quanta=1, frac=0.01, clipped=0.05)
TRUNK_TOL = dict(rel=0.05, quanta=8)
FUSED_TOL = dict(rel=0.1, quanta=16)
QGEMM_FRAMES = (FRAMES, TRAIN_FRAMES)
A_AMAX, RES_AMAX = 3.7, 2.2
EMBED_SECONDS = FRAMES // 12  # one embedding request: 8 seconds
EMBED_CLIPS = 32  # the JAX bench's embed train batch (bench.py:436-460): 32 clips of 1 second
# stft against its plain version, as the largest error over the peak
# magnitude. IEEE f32 on both sides, summed in another order over 246
# products of int16-range samples: about 1e-7 of the peak each. The limit
# must stay below what the plain version with TF32 reads against a float64
# witness (checked in the run; TF32 keeps 10 mantissa bits, some 3e-4).
STFT_TOL = 1e-5
# CUDA against the CPU, f32: the embedding latents of eval-mode encoders,
# within 1e-4 of the largest latent; the first train step's gradients in L2,
# the acoustic VAE (no BN) per tensor within 1e-3, the audio and video VAEs
# per VAE within 5e-2 (their train-mode BNs divide by fast-variance batch
# statistics, which magnify rounding: JAX eager against JAX jitted reads
# 3e-2 on one audio tensor on the CPU). The biases of the convs a train-mode
# BN follows have a true gradient of 0 and are left out.
# The two steps' updates (new - initial) per VAE in L2, relative: Adam
# normalizes each entry's step by its own gradient history, so an entry
# whose gradient is at rounding-noise level takes a full +-lr step with the
# sign the noise gives it. The acoustic VAE within 0.1; the audio and video
# VAEs, whose BN-amplified noise flips many such entries, within 0.5 and
# 0.3 (read 0.324 and 0.197 on an H100, 2 s, 2 steps).
EMBED_PATH_TOL = 1e-4
EMBED_GRAD_TOL = dict(acoustic=1e-3, audio=5e-2, video=5e-2)
EMBED_UPDATE_TOL = dict(acoustic=0.1, audio=0.5, video=0.3)


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


# (H, W) of every no-BN ConvConvPool stack, which runs on conv_chain: the
# generator's six and the embedding task's acoustic VAE's four
GEN_CHAINS = {"layer1": (36, 48), "layer2": (12, 16), "layer4": (12, 16), "layer5": (12, 16),
              "layer6": (36, 48), "layer7": (36, 48)}
EMBED_CHAINS = {"layer1": (36, 48), "layer3": (12, 16), "layer4": (36, 48), "layer5": (36, 48)}


def chain_layers(model, sizes: dict, frames: int):
    """(name, input (N,H,W,Ci) shape, packed f32 master weights) of the
    ConvConvPool stacks of ``model`` that ``sizes`` names, at ``frames``
    frames."""
    out = []
    for name, (h, w) in sizes.items():
        block = getattr(model, name)
        convs = [getattr(block, f"conv_{i + 1}") for i in range(block.n)]
        ci = convs[0].weight.shape[0] // 9
        out.append((name, (frames, h, w, ci), [c.weight.detach() for c in convs]))
    return out


def check_conv_chain(cc, chains, dtype, timed=True) -> tuple[float, dict]:
    """The forward kernel against its plain version on ``chains`` in bf16
    and f32, non-zero biases; with ``timed``, kernel, plain and cuDNN times
    in ``dtype``. Returns the largest error in ``dtype`` and the summed
    times, bytes and operations."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    err_main = 0.0
    for name, shape, ws in chains:
        relu = (True,) * len(ws)
        # non-zero biases (init_params zeroes them) so the bias add is checked
        bs = [0.1 * torch.randn(w.shape[1], generator=g, device="cuda") for w in ws]
        for dt in (torch.bfloat16, torch.float32):
            x = torch.relu(torch.randn(shape, generator=g, device="cuda")).to(dt)
            wd = [w.to(dt) for w in ws]
            err = compare(f"conv_chain {name} {str(dt)[6:]} {tuple(shape)}",
                          cc.conv_chain(x, wd, bs, relu), cc.conv_chain_reference(x, wd, bs, relu),
                          CHAIN_TOL[dt])
            if dt != dtype:
                continue
            err_main = max(err_main, err)
            if not timed:
                continue
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
            for k, v in dict(ms=ms, plain_ms=plain, library_ms=lib, flops=flops, nbytes=nbytes).items():
                tot[k] += v
    return err_main, tot


def conv_chain_entry(err: float, tot: dict, dtype) -> dict:
    """The ``kernels`` line's entry of the conv_chain forward: the
    generator's chains of one request, timed by ``check_conv_chain``."""
    b, by = bound_ms(tot["nbytes"], tot["flops"], dtype)
    log(f"time conv_chain all chains of one {FRAMES}-frame request: kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, cudnn {tot['library_ms']:.4f} ms, bound {b:.4f} ms "
        f"({by}), {tot['flops'] / 1e9:.1f} GFLOP")
    return dict(
        name="conv_chain", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/conv_chain.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_conv.py:388",
        max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
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


def check_conv_chain_backward(cc, chains, dtype, timed=True) -> tuple[float, dict]:
    """The backward kernels on ``chains`` (a train step's shapes), both
    dtypes, non-zero biases: bf16 against the plain backward, f32 against a
    float64 witness beside cuDNN's f32 and TF32 readings of the same grads;
    with ``timed``, times in ``dtype`` against autograd's backward of the
    cuDNN chain. Returns the largest error in ``dtype`` and the summed
    times, bytes and operations."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0, parts={})
    err_main = 0.0
    for name, shape, ws in chains:
        relu = (True,) * len(ws)
        needs_dx = name != "layer1"  # layer1's input (the MFCC map, an acoustic frame) needs no grad
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
            if dt != dtype:
                del got, want
                continue
            err_main = max(err_main, abs_err(got[0], want[0]) if needs_dx else 0.0,
                           *(abs_err(a, b) for a, b in zip(got[1] + got[2], want[1] + want[2])))
            del got, want
            if not timed:
                continue
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
            # each launch of the backward alone, on the inputs the backward gives it
            parts = {}
            for part, layer, fn, _ in cc.backward_parts(x, acts, wd, gy, relu, needs_dx):
                parts[f"{part} {layer}"] = t = time_ms(fn, iters=10)
                tot["parts"][part] = tot["parts"].get(part, 0.0) + t
            log(f"time conv_chain_backward {name} by launch (ms): "
                + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
            del y, inputs, xl, wl, bl
    return err_main, tot


def conv_chain_backward_entry(err: float, tot: dict, dtype) -> dict:
    """The ``kernels`` line's entry of the conv_chain backward: the
    generator's chains of one train step, timed by
    ``check_conv_chain_backward``."""
    b, by = bound_ms(tot["nbytes"], tot["flops"], dtype)
    log(f"time conv_chain_backward all chains of one {TRAIN_FRAMES}-frame step: kernels {tot['ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms, cudnn autograd {tot['library_ms']:.3f} ms, bound {b:.4f} ms "
        f"({by}), {tot['flops'] / 1e9:.1f} GFLOP; by part, each launch alone: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in tot["parts"].items()))
    return dict(
        name="conv_chain_backward", route="cuda",
        source="acoustic_image_generation_tpu_torch/csrc/conv_chain.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_conv.py:443",
        max_abs_err=err, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
        library_ms=tot["library_ms"],
    )


def check_padding(cc) -> None:
    """The bf16 kernels pad 133 channels to 136 (and 12 to 16). On a chain
    133 -> 133 -> 133 at 768 frames of 12x16 (layer2's and layer4's widths):
    the padded intermediates hold zeros in their added channels, the
    returned output and dx have 133 channels, are contiguous and match the
    plain versions. (The generator's chains check the padded shapes
    themselves: Ci = 12 and 133 in, Co = 133 out, data grads into 133 and
    256 channels.)"""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    chans, relu = (133, 133, 133), (True, True)
    ws = [(torch.randn(9 * a, b, generator=g, device="cuda") / (9 * a) ** 0.5).bfloat16()
          for a, b in zip(chans[:-1], chans[1:])]
    bs = [0.1 * torch.randn(b, generator=g, device="cuda") for b in chans[1:]]
    x = torch.relu(torch.randn(TRAIN_FRAMES, 12, 16, chans[0], generator=g, device="cuda")).bfloat16()
    y = cc.conv_chain(x, ws, bs, relu)
    acts = cc._forward_cuda(x, ws, bs, relu)
    gy = torch.randn(y.shape, generator=g, device="cuda").bfloat16()
    dx = cc.conv_chain_backward(x, acts, ws, gy, relu)[0]
    leaks = [int(cc.pad_channels(a, reuse=True)[..., a.shape[-1]:].count_nonzero()) for a in acts]
    shapes = [tuple(t.shape) for t in (y, dx, *acts)]
    ok = (all(n == 0 for n in leaks) and y.is_contiguous() and dx.is_contiguous()
          and all(sh[-1] == 133 for sh in shapes))
    err_y = compare("conv_chain padded 133 -> 133 -> 133 bf16", y, cc.conv_chain_reference(x, ws, bs, relu),
                    CHAIN_TOL[torch.bfloat16])
    err_dx = rel_err(dx, cc.conv_chain_backward_reference(x, acts, ws, gy, relu)[0])
    log(f"check padding: nonzero added channels of the intermediates {leaks}, shapes {shapes}, output and dx "
        f"contiguous {y.is_contiguous()} {dx.is_contiguous()}; y max abs {err_y:.3e}, dx {err_dx:.2e} of the "
        f"largest (tol {GRAD_TOL[torch.bfloat16]['dx']})")
    if not ok or err_dx > GRAD_TOL[torch.bfloat16]["dx"]:
        raise AssertionError("conv_chain: padded channels leak or the padded chain is off")


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


def qgemm_launches(blocks=None):
    """(rows per frame, K, N, residual, relu) of each of the 36 ``qgemm_s8``
    launches of one full-width trunk forward: every unit's projection
    shortcut (on the subsampled grid), conv1 and conv3."""
    from acoustic_image_generation_tpu_torch.models.resnet import RESNET50_BLOCKS

    out = []
    h, w, in_ch = 55, 74, 64  # after the stem and its max-pool
    for base, units, block_stride in blocks or RESNET50_BLOCKS:
        for u in range(1, units + 1):
            s = block_stride if u == units else 1
            ho, wo = -(-h // s), -(-w // s)
            if base * 4 != in_ch:
                out.append((ho * wo, in_ch, base * 4, False, False))
            out.append((h * w, in_ch, base, False, True))
            out.append((ho * wo, base, base * 4, True, True))
            h, w, in_ch = ho, wo, base * 4
    return out


def qgemm_case(g, m, k, n, res):
    """Random int8 operands for one ``qgemm_s8`` shape, and an output amax
    that about 1% of the float results exceed (read off the first 8192
    rows)."""
    x = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 0.01 + 1e-3
    bias = torch.randn(n, generator=g, device="cuda") * 0.5
    r = torch.randint(-127, 128, (m, n), generator=g, device="cuda", dtype=torch.int8) if res else None
    factor = A_AMAX / 127 * scale
    head = torch._int_mm(x[:8192], w.t().contiguous()).float() * factor + bias
    if res:
        head = head + r[:8192].float() * (RES_AMAX / 127)
    out_amax = torch.quantile(head.relu().flatten()[: 1 << 23], 0.99)
    return x, w, factor, bias, r, out_amax


def check_qgemm(qg) -> dict:
    """``qgemm_s8`` against its plain version at every distinct shape of the
    trunk's 36 launches, at 96 (a request) and 768 frames (a train step);
    kernel, plain and library times and the bound, per shape and summed over
    one trunk forward's launches. Returns the 96-frame line of ``kernels``."""
    from collections import Counter

    shapes = Counter(qgemm_launches())
    log(f"qgemm_s8: {sum(shapes.values())} launches per trunk forward, {len(shapes)} distinct (rows, K, N, "
        f"residual) shapes, {len({(k, n, r) for _, k, n, r, _ in shapes})} distinct (K, N, residual)")
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    result = {}
    for frames in QGEMM_FRAMES:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, ops=0.0, bound_ms=0.0)
        worst = dict(quanta=0, frac=0.0, clipped=0.0)
        for (rows, k, n, res, relu), count in shapes.items():
            m = frames * rows
            x, w, factor, bias, r, out_amax = qgemm_case(g, m, k, n, res)
            kw = dict(relu=relu, residual=r, residual_amax=torch.tensor(RES_AMAX, device="cuda") if res else None)
            got = qg.qgemm_s8(x, w, factor, bias, out_amax, **kw)
            want = qg.qgemm_s8_reference(x, w, factor, bias, out_amax, **kw)
            torch.cuda.synchronize()
            diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
            quanta, frac = int(diff.max()), float((diff > 0).sum()) / diff.numel()
            clipped = float((got.abs() == 127).sum()) / got.numel()
            del diff, want
            name = f"({m},{k})@({k},{n}){' +res' if res else ''}{' relu' if relu else ''}"
            log(f"check qgemm_s8 {frames} frames {name}: {quanta} quanta at most, on {frac:.2e} of the "
                f"entries, {clipped:.2e} clipped (tol {QGEMM_TOL})")
            if quanta > QGEMM_TOL["quanta"] or frac >= QGEMM_TOL["frac"] or not 0 < clipped < QGEMM_TOL["clipped"]:
                raise AssertionError(f"qgemm_s8 {name}: {quanta} quanta on {frac} of entries, {clipped} clipped")
            for key, v in dict(quanta=quanta, frac=frac, clipped=clipped).items():
                worst[key] = max(worst[key], v)
            fb, rs = qg._folded(factor, bias, out_amax, kw["residual_amax"], x.device)
            w_kn = w.t().contiguous()

            def library(x=x, w_kn=w_kn, fb=fb, rs=rs, r=r, relu=relu):
                return qg.requant(torch._int_mm(x, w_kn), fb, rs, r, relu)

            iters = 10 if frames == FRAMES else 5
            ms = time_ms(lambda: qg.qgemm_s8(x, w, factor, bias, out_amax, **kw), iters=iters)
            plain = time_ms(lambda: qg.qgemm_s8_reference(x, w, factor, bias, out_amax, **kw), iters=3, warmup=1)
            lib = time_ms(library, iters=3, warmup=1)
            nbytes = m * k + n * k + m * n * (2 if res else 1) + 8 * n
            ops = 2 * m * k * n
            b, by = bound_ms(nbytes, ops, torch.int8)
            log(f"time qgemm_s8 {frames} frames {name} x{count}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"_int_mm+epilogue {lib:.4f} ms, bound {b:.4f} ms ({by}), {ops / ms / 1e9:.1f} TOPS, "
                f"{nbytes / ms / 1e6:.1f} GB/s")
            for key, v in dict(ms=ms, plain_ms=plain, library_ms=lib, nbytes=nbytes, ops=ops, bound_ms=b).items():
                tot[key] += v * count
            del x, w, r, got, fb, w_kn
            torch.cuda.empty_cache()
        b, by = bound_ms(tot["nbytes"], tot["ops"], torch.int8)
        log(f"time qgemm_s8 one {frames}-frame trunk forward (36 launches): kernel {tot['ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, _int_mm+epilogue {tot['library_ms']:.3f} ms, bound {b:.3f} ms ({by}; "
            f"{tot['nbytes'] / 1e9:.2f} GB, {tot['ops'] / 1e12:.2f} Tops; per-launch bounds summed "
            f"{tot['bound_ms']:.3f} ms); worst {worst}")
        result[frames] = dict(
            name="qgemm_s8", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/qgemm_s8.cu",
            replaces="acoustic_image_generation_tpu/ops/pallas_qgemm.py:172",
            max_abs_err=worst["quanta"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=tot["library_ms"],
        )
    return result[FRAMES]


def trunk_gap(got, want, quantum) -> tuple[float, float]:
    """(relative L2 error, largest error in quanta of the last site)."""
    got, want = got.double().flatten(), want.double().flatten()
    rel = float((got - want).norm() / want.norm())
    return rel, float((got - want).abs().max()) / quantum


def check_int8_trunk(qg) -> None:
    """The full-width int8 trunk on the card, 96 frames, from the seeded
    trunk of ``check_trunk`` (BN statistics away from their initial values):
    fused (``qgemm_s8``) against unfused (``_int_mm``), CUDA against the CPU
    on 2 frames in f32, and int8 against the bf16 eval trunk; trunk times."""
    from acoustic_image_generation_tpu_torch.models.quant import calibrate, quantize_trunk, trunk_forward

    resnet = check_trunk(False, torch.bfloat16)
    video = torch.rand((FRAMES, 224, 298, 3), generator=torch.Generator(device="cuda").manual_seed(SEED + 12),
                       device="cuda")
    with torch.no_grad():
        qt = calibrate(quantize_trunk(resnet), video)
        quantum = float(qt.amax(f"block4_unit_{3}/out")) / 127
        torch.cuda.synchronize()
        qg.qgemm_s8.launches = 0
        fused = trunk_forward(qt, video, out_dtype=torch.float32, fused_gemm=True)[0]
        torch.cuda.synchronize()
        n = qg.qgemm_s8.launches
        unfused = trunk_forward(qt, video, out_dtype=torch.float32)[0]
        rel, quanta = trunk_gap(fused, unfused, quantum)
        log(f"int8 trunk {FRAMES} frames: {n} qgemm_s8 launches (expected 36); fused vs unfused: relative "
            f"{rel:.3e}, {quanta:.1f} quanta at most (tol {FUSED_TOL})")
        if n != 36 or rel >= FUSED_TOL["rel"] or quanta > FUSED_TOL["quanta"]:
            raise AssertionError("int8 trunk: fused and unfused differ, or the launches are off")
        ref = resnet(video, mode="trunk").float()
        rel_q = float((fused - ref).norm() / ref.norm())
        corr = float(torch.corrcoef(torch.stack([fused.flatten(), ref.flatten()]))[0, 1])
        log(f"int8 trunk against the bf16 eval trunk (a property of the quantization): relative {rel_q:.4f}, "
            f"correlation {corr:.5f}")
        if not torch.isfinite(fused).all():
            raise AssertionError("int8 trunk features not finite")
        ms_f = time_ms(lambda: trunk_forward(qt, video, fused_gemm=True), iters=5)
        ms_u = time_ms(lambda: trunk_forward(qt, video), iters=5)
        ms_b = time_ms(lambda: resnet(video, mode="trunk"), iters=5)
        log(f"time trunk {FRAMES} frames (device): int8 fused {ms_f:.3f} ms, int8 unfused {ms_u:.3f} ms, "
            f"bf16 eval {ms_b:.3f} ms")
        del fused, unfused, ref
        # CUDA (kernel) against the CPU (plain versions), 2 frames, f32 out
        small = video[:2]
        on_card = trunk_forward(qt, small, out_dtype=torch.float32, fused_gemm=True)[0].cpu()
        qt_cpu = qt.to("cpu")
        on_cpu = trunk_forward(qt_cpu, small.cpu(), out_dtype=torch.float32, fused_gemm=True)[0]
        rel, quanta = trunk_gap(on_card, on_cpu, quantum)
        log(f"int8 trunk cuda vs cpu (2 frames, fused, f32 out): relative {rel:.3e}, {quanta:.1f} quanta at "
            f"most, equal {torch.equal(on_card, on_cpu)} (tol {TRUNK_TOL})")
        if rel >= TRUNK_TOL["rel"] or quanta > TRUNK_TOL["quanta"]:
            raise AssertionError("int8 trunk: CUDA and CPU differ")


def train_batch(rng, clips, frames_per_clip=12):
    """One synthetic batch of raw clips, as the JAX bench makes it."""
    f = (clips, frames_per_clip)
    return dict(
        acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
        audio=rng.integers(-(2**15), 2**15, (*f, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
    )


def train(counters: dict, per_step: dict, label: str, **config) -> dict:
    """TRAIN_STEPS full-width bf16 train steps on one fixed batch with
    ``GenerationConfig(**config)``, the launch counts of ``counters``
    (name -> wrapper) reset just before and read just after. Checks: the
    loss falls, the trunk is bit-frozen (with ``trunk_quant="int8"`` its
    int8 buffers too, from the first step's calibration on), every trained
    tensor moves, and the trunk's BN statistics move with
    ``trunk_bn="train"`` and stay put with ``"frozen"``. Returns the launch
    counts and ``{median, first, peak, stages}``."""
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    task = GenerationTask(GenerationConfig(seed=SEED, **config), device="cuda").init_params(SEED)
    trainer = Trainer(task)
    state = trainer.init_state()
    raw = train_batch(np.random.default_rng(SEED + 4), TRAIN_CLIPS)
    labels = task.param_labels()
    before = {n: p.detach().clone() for n, p in task.named_parameters()}
    stats_before = {n: b.clone() for n, b in task.resnet.named_buffers() if not n.startswith("conv_map")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, raw)
        losses.append(float(metrics["loss"]))  # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        log(f"train {label} step {state.step}: {times[-1]:.1f} ms, "
            + ", ".join(f"{k} {float(v):.6g}" for k, v in metrics.items()))
        if state.step == 1 and trainer.qtrunk is not None:
            q_before = {n: b.clone() for n, b in trainer.qtrunk.named_buffers()}
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"train {label}: launches over {TRAIN_STEPS} steps: {launches} (expected {per_step} per step: "
        "conv_chain_backward = 6 gate (one a chain) + 12 weight-grad + 11 data-grad (each gating the layer "
        "before it), layer1's input needs none)")
    for k, v in per_step.items():
        if launches[k] != v * TRAIN_STEPS:
            raise AssertionError(f"train {label} {k}: {launches[k]} launches, expected {v * TRAIN_STEPS}")
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {label}: {TRAIN_CLIPS} clips x 12 frames per step, first step {times[0]:.1f} ms, median of "
        f"the next {TRAIN_STEPS - 1} {steady:.1f} ms, {TRAIN_CLIPS / steady * 1e3:.1f} clips/s, "
        f"peak device memory {peak:.3f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train {label} losses {losses}: not finite or not lower after the last step")
    for n, p in task.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if labels[n] == "frozen" and not same:
            raise AssertionError(f"frozen parameter {n} changed")
        if labels[n] == "train" and same:
            raise AssertionError(f"trained parameter {n} did not change")
    stats_moved = [n for n, b in task.resnet.named_buffers() if n in stats_before and not torch.equal(b, stats_before[n])]
    if task.cfg.trunk_bn == "train" and not stats_moved:
        raise AssertionError("the trunk's BN running statistics did not change")
    if task.cfg.trunk_bn == "frozen" and stats_moved:
        raise AssertionError(f"frozen trunk BN statistics changed: {stats_moved[:3]}")
    if trainer.qtrunk is not None:
        q_moved = [n for n, b in trainer.qtrunk.named_buffers() if not torch.equal(b, q_before[n])]
        if q_moved:
            raise AssertionError(f"int8 trunk buffers changed after calibration: {q_moved[:3]}")
    log(f"train {label} checks: losses {losses[0]:.6g} -> {losses[-1]:.6g}, trunk bit-frozen"
        + (", int8 trunk bit-frozen after its calibration" if trainer.qtrunk is not None else "")
        + f", {sum(l == 'train' for l in labels.values())} trained tensors changed, trunk BN statistics "
        + ("moved" if stats_moved else "unchanged"))
    stages = train_stages(trainer, state, raw, label)
    profile(lambda: trainer.train_step(state, raw), f"train step {label}")
    return launches, dict(median=steady, first=times[0], peak=peak, stages=stages)


def train_stages(trainer, state, raw, label) -> dict:
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
        if trainer.qtrunk is not None:
            feat = task.trunk_features(batch.video, trainer.qtrunk)
        else:
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
    log(f"stages of one train step {label} (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {ev[0].elapsed_time(ev[-1]):.3f}")
    return parts


def profile(fn, what: str, rows: int = 15) -> None:
    """Device time by kernel for one call of ``fn`` (a request or a train
    step) under torch.profiler, and the device's idle share of its wall
    time (profiling included)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile of one {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle {100 * (1 - busy / wall):.1f}%, {len(kernels)} distinct kernels")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:rows]:
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


def serve(service, counters: dict, per_request: dict, label: str) -> tuple[dict, list, dict]:
    """REQUESTS requests of FRAMES frames through ``service``, the launch
    counts of ``counters`` (name -> wrapper) reset just before and read just
    after; returns them, the requests and ``{median, first, peak}``."""
    rng = np.random.default_rng(SEED)
    reqs = [request(rng) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
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
        log(f"request {label} {i}: {FRAMES} frames, {times[-1]:.2f} ms, output range "
            f"[{float(gen.min()):.4f}, {float(gen.max()):.4f}], energy mean {float(energy.mean()):.4e}")
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches over {REQUESTS} requests {label}: {launches} (expected {per_request} per request)")
    for k, v in per_request.items():
        if launches[k] != v * REQUESTS:
            raise AssertionError(f"{label} {k}: {launches[k]} launches, expected {v * REQUESTS}")
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"serving {label}: first request {times[0]:.2f} ms, median of the next {REQUESTS - 1} "
        f"{steady:.2f} ms, {FRAMES / 12 / steady * 1e3:.1f} clips/s ({FRAMES / steady * 1e3:.0f} frames/s), "
        f"peak device memory {peak:.3f} GiB")
    return launches, reqs, dict(median=steady, first=times[0], peak=peak)


def stage_breakdown(task, audio, video, label, qtrunk=None) -> dict:
    """Device time of each stage of one request, by CUDA events; the trunk
    stage includes ``conv_map``."""
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
            if qtrunk is None:
                feat = task.resnet(batch.video, mode="full")
            else:
                feat = task.resnet(task.trunk_features(batch.video, qtrunk), mode="head")
            ev[3].record()
            out = task.generator(tile_mfccmap(batch.mfcc).to(task.dtype), feat, generator=g)
            ev[4].record()
            find_logen(out.output.float())
            ev[5].record()
            torch.cuda.synchronize()
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    total = ev[0].elapsed_time(ev[-1])
    log(f"stages of one request {label} (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {total:.3f}")
    return parts


def summary(got: dict, base: dict) -> str:
    """One line of median, first, peak and trunk stage, ``got`` against
    ``base``."""
    return (f"median {got['median']:.2f} vs {base['median']:.2f} ms, first {got['first']:.2f} vs "
            f"{base['first']:.2f} ms, trunk stage {got['stages']['trunk']:.3f} vs {base['stages']['trunk']:.3f} ms, "
            f"peak {got['peak']:.3f} vs {base['peak']:.3f} GiB")


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


def check_stft(st) -> dict:
    """The ``stft`` kernel against its plain version (TF32 off) at an
    embedding request's 8 seconds and a train step's 32, with a float64
    witness on the same f32 bases beside it; times of kernel, plain version
    and the ``torch.stft`` yardstick (cuFFT). Returns the 32-second line of
    ``kernels``."""
    import torch.nn.functional as F

    from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    window = torch.hann_window(spec.FRAME_LENGTH, periodic=True, device="cuda")
    pad = (spec.FFT_LENGTH - spec.FRAME_LENGTH) // 2  # torch centres the window in the frame
    for seconds in (EMBED_SECONDS, EMBED_CLIPS):
        x = torch.randint(-(2**15), 2**15, (seconds, spec.SAMPLES_PER_SECOND), generator=g, device="cuda").float()
        got, want = st.stft(x), st.stft_plain(x)
        frames = x.double().unfold(-1, spec.FRAME_LENGTH, spec.FRAME_STEP)
        cos_b, sin_b = (b.double() for b in spec.device_bases(x.device))
        witness = torch.sqrt(torch.square(frames @ cos_b) + torch.square(frames @ sin_b))

        def library(x=x):
            return torch.stft(F.pad(x, (pad, pad)), n_fft=spec.FFT_LENGTH, hop_length=spec.FRAME_STEP,
                              win_length=spec.FRAME_LENGTH, window=window, center=False,
                              return_complex=True).abs()

        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = rel_err(st.stft_plain(x), witness)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        err = rel_err(got, want)
        log(f"check stft {seconds} s ({tuple(x.shape)} -> {tuple(got.shape)}): kernel vs plain {err:.3e} of the "
            f"peak (tol {STFT_TOL}); against the float64 witness: kernel {rel_err(got, witness):.3e}, plain "
            f"{rel_err(want, witness):.3e}, plain with TF32 {tf32:.3e}, torch.stft "
            f"{rel_err(library().transpose(-1, -2), witness):.3e}")
        if not STFT_TOL < tf32:
            raise AssertionError(f"stft: the limit {STFT_TOL} does not exclude a TF32 run ({tf32:.2e})")
        if err > STFT_TOL:
            raise AssertionError(f"stft {seconds} s: kernel off its plain version by {err:.2e} of the peak")
        ms = time_ms(lambda: st.stft(x))
        plain = time_ms(lambda: st.stft_plain(x))
        lib = time_ms(library)
        flops = seconds * spec.NUM_FRAMES * spec.FRAME_LENGTH * spec.NUM_BINS * 2 * 2  # two GEMMs
        nbytes = (x.numel() + got.numel() + 2 * spec.FRAME_LENGTH * spec.NUM_BINS) * 4
        b, by = bound_ms(nbytes, flops, torch.float32)
        log(f"time stft {seconds} s: kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.stft {lib:.4f} ms, bound "
            f"{b:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), {flops / ms / 1e9:.2f} TFLOP/s")
    return dict(
        name="stft", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/stft.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_stft.py:77",
        max_abs_err=float((got - want).abs().max()), ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        library_ms=lib,
    )


def embed_task(compute_dtype: str, device: str):
    """A full-width ``EmbedTask`` with ``init_params``' distributions from
    the seed, and biases, BN scales and running statistics drawn away from
    their initial values (on the CPU, so every device gets the same)."""
    from acoustic_image_generation_tpu_torch.models.layers import BatchNorm
    from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask

    task = EmbedTask(EmbedConfig(compute_dtype=compute_dtype, seed=SEED), device=device).init_params(SEED)
    randomize_biases(task, SEED + 14)
    g = torch.Generator().manual_seed(SEED + 15)
    with torch.no_grad():
        for m in task.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.75 + 0.5 * torch.rand(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return task


def embed_request(rng, n=FRAMES):
    """Model-ready f32 frames of one request: acoustic and video in [0, 1],
    int16-range audio samples."""
    return (rng.random((n, 36, 48, 12), dtype=np.float32),
            rng.integers(-(2**15), 2**15, (n, 1024)).astype(np.float32),
            rng.random((n, 224, 298, 3), dtype=np.float32))


def serve_embedding(service, counters: dict, per_request: dict) -> tuple[dict, list, dict]:
    """REQUESTS embedding requests of FRAMES frames, the launch counts of
    ``counters`` reset just before and read just after."""
    rng = np.random.default_rng(SEED + 16)
    reqs = [embed_request(rng) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for i, req in enumerate(reqs):
        t0 = time.perf_counter()
        z = service(*req, seed=SEED + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for name, t in zip(("acoustic", "audio", "video"), z):
            if t.shape != (EMBED_SECONDS, service.task.cfg.latent_dim) or not torch.isfinite(t).all():
                raise AssertionError(f"embedding request {i}: {name} latents {tuple(t.shape)} not finite or misshapen")
        log(f"embedding request {i}: {FRAMES} frames ({EMBED_SECONDS} s), {times[-1]:.2f} ms, latent norms "
            + ", ".join(f"{n} {float(t.norm(dim=1).mean()):.4g}" for n, t in zip(("acoustic", "audio", "video"), z)))
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches over {REQUESTS} embedding requests: {launches} (expected {per_request} per request: "
        "conv_chain = the acoustic encoder's 2 chains x 2 convs)")
    for k, v in per_request.items():
        if launches[k] != v * REQUESTS:
            raise AssertionError(f"embedding serving {k}: {launches[k]} launches, expected {v * REQUESTS}")
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"embedding serving: first request {times[0]:.2f} ms, median of the next {REQUESTS - 1} {steady:.2f} ms, "
        f"{EMBED_SECONDS / steady * 1e3:.1f} seconds of input/s, peak device memory {peak:.3f} GiB")
    return launches, reqs, dict(median=steady, first=times[0], peak=peak)


def embed_serving_stages(task, req) -> dict:
    """Device time of each stage of one embedding request, by CUDA events;
    each encoder stage includes its VAE head."""
    from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND, resize_frames
    from acoustic_image_generation_tpu_torch.ops.stft import stft

    names = ("upload", "stft", "resize", "acoustic encoder", "audio encoder", "video encoder")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one reported
            torch.cuda.synchronize()
            ev[0].record()
            ac, audio, video = (torch.from_numpy(a).cuda() for a in req)
            ev[1].record()
            spec = stft(audio.reshape(-1, SAMPLES_PER_SECOND))
            ev[2].record()
            spec = resize_frames(spec)[..., None]
            ev[3].record()
            for i, (model, x) in enumerate(((task.acoustic, ac[::12]), (task.audio, spec), (task.video, video[::12]))):
                model.vae(model.features(x))
                ev[4 + i].record()
            torch.cuda.synchronize()
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    log("stages of one embedding request (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {ev[0].elapsed_time(ev[-1]):.3f}")
    return parts


def check_embedding_against_cpu() -> None:
    """The same f32 weights (non-zero biases and BN statistics) and noise
    through ``EmbeddingService`` on CUDA (the stft and conv_chain kernels)
    and on the CPU (plain versions), 2 seconds."""
    from acoustic_image_generation_tpu_torch.serving import EmbeddingService

    rng = np.random.default_rng(SEED + 17)
    req = embed_request(rng, n=24)
    eps = rng.standard_normal((2, 128)).astype(np.float32)
    outs = [[z.cpu() for z in EmbeddingService(embed_task("float32", dev))(*req, seed=SEED, eps=eps)]
            for dev in ("cuda", "cpu")]
    errs = {name: rel_err(a, b) for name, a, b in zip(("acoustic", "audio", "video"), *outs)}
    log("check embedding serving f32 cuda vs cpu (2 s): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" of the largest latent (tol {EMBED_PATH_TOL})")
    if max(errs.values()) > EMBED_PATH_TOL:
        raise AssertionError(f"CUDA and CPU embedding latents differ: {errs}")


def embed_train_batch(rng, clips, amplitude=2**15):
    """One synthetic batch of 1-second clips, as the JAX bench makes its
    embed batch: actions over 10 classes, location 0."""
    f = (clips, 12)
    return dict(
        acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
        audio=rng.integers(-amplitude, amplitude, (*f, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
        action=rng.integers(0, 10, (clips,)).astype(np.int32),
        location=np.zeros((clips,), np.int32),
    )


def modality_mse(task, batch) -> dict:
    """Train-mode reconstruction MSE of each VAE on ``batch``, with the BN
    running averages put back afterwards."""
    from acoustic_image_generation_tpu_torch.losses.recon import mse_tf
    from acoustic_image_generation_tpu_torch.train.generation import no_tf32

    saved = {n: b.clone() for n, b in task.named_buffers()}
    with torch.no_grad(), no_tf32():
        inputs, outs = task._forward(batch, train=True)
        out = {n: float(mse_tf(x, o.output)) for n, x, o in zip(("acoustic", "audio", "video"), inputs, outs)}
        for n, b in task.named_buffers():
            b.copy_(saved[n])
    return out


def train_embedding(counters: dict, per_step: dict) -> tuple[dict, dict]:
    """TRAIN_STEPS full-width bf16 steps of the embedding task (triplet) on
    one fixed batch of EMBED_CLIPS clips, the launch counts reset just
    before and read just after. Checks: every loss term finite, the acoustic
    and video reconstructions better after the steps (the audio VAE's MSE
    against raw magnitudes of about 1e5 is printed: five steps of 1e-4
    barely move it), every trained tensor moved, the audio and video BN
    running averages moved."""
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    task = embed_task("bfloat16", "cuda")
    trainer = Trainer(task)
    state = trainer.init_state()
    raw = embed_train_batch(np.random.default_rng(SEED + 18), EMBED_CLIPS)
    before = {n: p.detach().clone() for n, p in task.named_parameters()}
    stats_before = {n: b.clone() for n, b in task.named_buffers()}
    batch = trainer._prepare(raw)
    mse_before = modality_mse(task, batch)
    del batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, raw)
        losses.append({k: float(v) for k, v in metrics.items()})  # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        log(f"train embedding step {state.step}: {times[-1]:.1f} ms, "
            + ", ".join(f"{k} {v:.6g}" for k, v in losses[-1].items()))
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"train embedding: launches over {TRAIN_STEPS} steps: {launches} (expected {per_step} per step: "
        "conv_chain = 4 chains x 2 convs of the acoustic VAE; conv_chain_backward = 4 gate + 8 weight-grad "
        "+ 7 data-grad, layer1's input needs none)")
    for k, v in per_step.items():
        if launches[k] != v * TRAIN_STEPS:
            raise AssertionError(f"train embedding {k}: {launches[k]} launches, expected {v * TRAIN_STEPS}")
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train embedding: {EMBED_CLIPS} clips x 12 frames per step, first step {times[0]:.1f} ms, median of the "
        f"next {TRAIN_STEPS - 1} {steady:.1f} ms, {EMBED_CLIPS / steady * 1e3:.1f} clips/s, peak device memory "
        f"{peak:.3f} GiB")
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError("train embedding: a loss term is not finite")
    batch = trainer._prepare(raw)
    mse_after = modality_mse(task, batch)
    del batch
    log("train embedding reconstruction MSE per VAE, before -> after the steps: "
        + ", ".join(f"{k} {mse_before[k]:.6g} -> {mse_after[k]:.6g}" for k in mse_before))
    for k in ("acoustic", "video"):
        if not mse_after[k] < mse_before[k]:
            raise AssertionError(f"train embedding: the {k} reconstruction did not improve")
    still = [n for n, p in task.named_parameters() if torch.equal(p.detach(), before[n])]
    if still:
        raise AssertionError(f"trained parameters did not change: {still[:5]}")
    stuck = [n for n, b in task.named_buffers() if torch.equal(b, stats_before[n])]
    if stuck:
        raise AssertionError(f"BN running statistics did not change: {stuck[:5]}")
    log(f"train embedding checks: {len(before)} trained tensors and {len(stats_before)} BN statistics moved")
    stages = embed_train_stages(trainer, state, raw)
    profile(lambda: trainer.train_step(state, raw), "embedding train step")
    return launches, dict(median=steady, first=times[0], peak=peak, stages=stages)


def embed_train_stages(trainer, state, raw) -> dict:
    """Device time of each stage of one embedding train step, by CUDA
    events: the calls of ``Trainer.train_step``, split where the events go."""
    from acoustic_image_generation_tpu_torch.train.generation import no_tf32
    from acoustic_image_generation_tpu_torch.train.trainer import step_generator

    task = trainer.task
    names = ("prepare", "stft + resize", "acoustic forward", "audio forward", "video forward", "loss",
             "backward", "optimizer")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with no_tf32():
        torch.cuda.synchronize()
        ev[0].record()
        batch = trainer._prepare(raw)
        ev[1].record()
        ac, spec, video = task.inputs(batch)
        ev[2].record()
        ac_out = task.acoustic(ac)
        ev[3].record()
        au_out = task.audio(spec, train=True)
        ev[4].record()
        vi_out = task.video(video, train=True)
        ev[5].record()
        total, _ = task.objective((ac, spec, video), (ac_out, au_out, vi_out), batch,
                                  generator=step_generator(SEED, state.step, "cuda"))
        ev[6].record()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[7].record()
        state.optimizer.step()
        ev[8].record()
        torch.cuda.synchronize()
    state.step += 1
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    log("stages of one embedding train step (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {ev[0].elapsed_time(ev[-1]):.3f}")
    return parts


def check_embed_train_against_cpu() -> None:
    """Two f32 embedding train steps on 2 seconds (low-amplitude audio, so
    that the audio VAE's loss stays well conditioned), on CUDA and on the
    CPU, from the same weights and noise: the losses within 1e-4 relative,
    the first step's gradients (``EMBED_GRAD_TOL``) and the updates
    (``EMBED_UPDATE_TOL``), per VAE in L2."""
    import re

    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    raw = embed_train_batch(np.random.default_rng(SEED + 19), 2, amplitude=4)
    eps = np.random.default_rng(SEED + 20).standard_normal((2, 2, 128)).astype(np.float32)
    runs = []
    for dev in ("cuda", "cpu"):
        task = embed_task("float32", dev)
        init = {n: p.detach().cpu().clone() for n, p in task.named_parameters()}
        trainer = Trainer(task)
        state = trainer.init_state()
        losses = []
        for s, e in enumerate(eps):
            losses.append(float(trainer.train_step(state, raw, eps=e)[1]["loss"]))
            if s == 0:
                grads = {n: p.grad.detach().cpu().clone() for n, p in task.named_parameters()}
        runs.append((losses, grads, {n: p.detach().cpu() - init[n] for n, p in task.named_parameters()}))
    (l_cuda, g_cuda, d_cuda), (l_cpu, g_cpu, d_cpu) = runs
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_cuda, l_cpu))
    cancelled = re.compile(r"^(audio|video)\.layer\d+\.(conv|pool)_\d\.bias$")
    sums = {m: [0.0, 0.0] for m in EMBED_GRAD_TOL}
    worst_acoustic = 0.0
    for n, want in g_cpu.items():
        if cancelled.match(n):
            continue
        model = n.split(".")[0]
        gap, norm = float((g_cuda[n] - want).norm()) ** 2, float(want.norm()) ** 2
        if model == "acoustic":
            worst_acoustic = max(worst_acoustic, (gap / max(norm, 1e-60)) ** 0.5)
        else:
            sums[model][0] += gap
            sums[model][1] += norm
    grad_err = dict(acoustic=worst_acoustic, **{m: (g / w) ** 0.5 for m, (g, w) in sums.items() if m != "acoustic"})
    update_err = {}
    for model in EMBED_UPDATE_TOL:
        names = [n for n in d_cpu if n.split(".")[0] == model and not cancelled.match(n)]
        gap = sum(float((d_cuda[n] - d_cpu[n]).norm()) ** 2 for n in names)
        update_err[model] = (gap / sum(float(d_cpu[n].norm()) ** 2 for n in names)) ** 0.5
    log(f"check embedding train f32 cuda vs cpu (2 s, 2 steps): losses {l_cuda} vs {l_cpu}, relative error "
        f"{loss_err:.2e} (tol 1e-4); first-step gradients " + ", ".join(f"{k} {v:.2e}" for k, v in grad_err.items())
        + f" (tol {EMBED_GRAD_TOL}); update gaps in L2 " + ", ".join(f"{k} {v:.3e}" for k, v in update_err.items())
        + f" (tol {EMBED_UPDATE_TOL})")
    if not (loss_err <= 1e-4 and all(update_err[k] <= v for k, v in EMBED_UPDATE_TOL.items())
            and all(grad_err[k] <= v for k, v in EMBED_GRAD_TOL.items())):
        raise AssertionError("CUDA and CPU embedding train steps differ")


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
    from acoustic_image_generation_tpu_torch.ops import qgemm as qg
    from acoustic_image_generation_tpu_torch.ops import stft as st
    from acoustic_image_generation_tpu_torch.serving import EmbeddingService, GenerationService
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
    acoustic = embed_task("bfloat16", "cuda").acoustic
    with torch.no_grad():
        # the conv_chain kernels at every shape the main path gives them: the
        # generator's chains (timed) and the acoustic VAE's, at a request's
        # and at a train step's frames
        err_f, fwd = check_conv_chain(cc, chain_layers(task.generator, GEN_CHAINS, FRAMES), task.dtype)
        err_fe, _ = check_conv_chain(cc, chain_layers(acoustic, EMBED_CHAINS, EMBED_SECONDS), task.dtype,
                                     timed=False)
        err_b, bwd = check_conv_chain_backward(cc, chain_layers(task.generator, GEN_CHAINS, TRAIN_FRAMES),
                                               task.dtype)
        err_be, _ = check_conv_chain_backward(cc, chain_layers(acoustic, EMBED_CHAINS, EMBED_CLIPS),
                                              task.dtype, timed=False)
        check_padding(cc)
        kernels = [check_mfcc(mk), conv_chain_entry(max(err_f, err_fe), fwd, task.dtype),
                   conv_chain_backward_entry(max(err_b, err_be), bwd, task.dtype),
                   check_matmul_stats(cs, task), check_qgemm(qg), check_stft(st)]
    del acoustic
    torch.cuda.empty_cache()

    phase = time.perf_counter()
    service = GenerationService(task)
    per_request = {"mfcc": 1, "conv_chain": 12}  # 1 frontend launch; 6 chains x 2 convs
    launches, reqs, served = serve(service, {"mfcc": mk.mfcc, "conv_chain": cc.conv_chain}, per_request, "bf16")
    served["stages"] = stage_breakdown(task, *reqs[0], "bf16")
    profile(lambda: service(*reqs[0], seed=SEED), "request bf16", rows=12)
    check_against_cpu()
    del service, task, reqs
    torch.cuda.empty_cache()
    log(f"phase serving: {time.perf_counter() - phase:.1f} s")

    phase = time.perf_counter()
    chain = {"mfcc": mk.mfcc, "conv_chain": cc.conv_chain, "conv_chain_backward": cc.conv_chain_backward}
    per_step = {"mfcc": 1, "conv_chain": 12, "conv_chain_backward": 6 + 12 + 11}
    launches["conv_chain_backward"] = train(chain, per_step, "bf16")[0]["conv_chain_backward"]
    torch.cuda.empty_cache()
    check_train_against_cpu()
    log(f"phase training: {time.perf_counter() - phase:.1f} s")
    phase = time.perf_counter()
    launches["matmul_stats"] = check_fused_bn_stats(cs)
    log(f"phase fused_bn_stats: {time.perf_counter() - phase:.1f} s")

    # the int8 frozen trunk: BN folded, W8A8, every 1x1 conv on qgemm_s8
    int8 = dict(trunk_bn="frozen", trunk_quant="int8", fused_qgemm=True)
    phase = time.perf_counter()
    check_int8_trunk(qg)
    torch.cuda.empty_cache()
    log(f"phase int8 trunk: {time.perf_counter() - phase:.1f} s")
    phase = time.perf_counter()
    task = GenerationTask(GenerationConfig(**int8), device="cuda").init_params(SEED)
    service = GenerationService(task)  # calibrated from its first request
    counters = {"qgemm_s8": qg.qgemm_s8, "conv_chain": cc.conv_chain, "mfcc": mk.mfcc}
    got, reqs, served_q = serve(service, counters, dict(per_request, qgemm_s8=36), "int8")
    launches["qgemm_s8"] = got["qgemm_s8"]
    served_q["stages"] = stage_breakdown(task, *reqs[0], "int8", qtrunk=service.qtrunk)
    profile(lambda: service(*reqs[0], seed=SEED), "request int8", rows=12)
    log("serving int8 beside bf16, same run: " + summary(served_q, served))
    del service, task, reqs
    torch.cuda.empty_cache()
    log(f"phase int8 serving: {time.perf_counter() - phase:.1f} s")
    phase = time.perf_counter()
    trained_q = train(dict(chain, qgemm_s8=qg.qgemm_s8), dict(per_step, qgemm_s8=36), "int8", **int8)[1]
    torch.cuda.empty_cache()
    trained_f = train(chain, per_step, "bf16 frozen trunk", trunk_bn="frozen")[1]
    torch.cuda.empty_cache()
    log("train int8 beside the bf16 frozen trunk, same run: " + summary(trained_q, trained_f))
    log(f"phase int8 training: {time.perf_counter() - phase:.1f} s")

    # the embedding family: three VAEs, stft frontend, triplet alignment
    every = {"stft": st.stft, "conv_chain": cc.conv_chain, "conv_chain_backward": cc.conv_chain_backward,
             "mfcc": mk.mfcc, "matmul_stats": cs.matmul_stats, "qgemm_s8": qg.qgemm_s8}
    phase = time.perf_counter()
    task = embed_task("bfloat16", "cuda")
    service = EmbeddingService(task)
    per_embed = dict(dict.fromkeys(every, 0), stft=1, conv_chain=4)
    got, reqs, _ = serve_embedding(service, every, per_embed)
    launches["stft"] = got["stft"]
    embed_serving_stages(task, reqs[0])
    profile(lambda: service(*reqs[0], seed=SEED), "embedding request", rows=12)
    del service, task, reqs
    torch.cuda.empty_cache()
    check_embedding_against_cpu()
    log(f"phase embedding serving: {time.perf_counter() - phase:.1f} s")
    phase = time.perf_counter()
    per_embed_step = dict(per_embed, conv_chain=8, conv_chain_backward=4 + 8 + 7)
    launches["stft"] += train_embedding(every, per_embed_step)[0]["stft"]
    torch.cuda.empty_cache()
    check_embed_train_against_cpu()
    log(f"phase embedding training: {time.perf_counter() - phase:.1f} s")
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
