"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --trunk-gemms [--package-root DIR]
    python3 chip_smoke.py --frontends [--package-root DIR]
    python3 chip_smoke.py --cached
    python3 chip_smoke.py --workflow
    python3 chip_smoke.py --classify
    python3 chip_smoke.py --embed-workflow
    python3 chip_smoke.py --task-families
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --parallel
    python3 chip_smoke.py --convert

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``), ``g++`` with zlib's headers and
PyTorch built for CUDA. It imports nothing of JAX. ``--trunk-gemms`` runs
only phase 2's checks and times of ``matmul_stats`` and ``qgemm_s8``,
``--frontends`` those of ``mfcc`` and ``stft`` (of the checkout at ``DIR``,
such as a parent commit's, with ``--package-root``), ``--cached`` phase 10
alone, ``--workflow`` phase 11 alone, ``--classify`` phase 12 alone (with
the ``sosfilt`` check), ``--embed-workflow`` phase 13 alone,
``--task-families`` phase 14 alone (with the ``conv_chain`` checks at
UNetEnergy's chains), ``--serving`` phase 15 alone (on its own shards and
a checkpoint of random weights), ``--parallel`` phase 16 alone (on its own
shards), ``--convert`` phase 17 alone; none prints a result line. Phases, each fatal on
failure:

1. build every kernel of ``acoustic_image_generation_tpu_torch/csrc`` with
   ``nvcc``, all at once, into ``build/aig_torch_kernels/``;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it (serving: 96 frames; training: 768 frames; the
   f32 backward against a float64 witness), and time kernel, plain version
   and a library yardstick with CUDA events (``mfcc`` and ``stft`` also by
   the profiler's device time and by the host's time per call, both in
   their ``kernels`` entries; ``mfcc`` also against a float64 witness on
   noise and on a loud tone); the ``conv_chain`` backward also launch by
   launch (gate, weight grad, data grad of each layer), and its channel
   padding (133 -> 136) is checked for leaks, and both are held and timed
   at UNetEnergy's ten narrow chains (1 to 32 channels in, 8 and 16 out) at
   384 frames; ``matmul_stats`` and
   ``qgemm_s8`` at every shape of one trunk forward's 36 launches, with
   per-launch bounds and launch plans;
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
10. cached-feature training from TFRecord shards: write 128 one-second
   synthetic shards under ``build/chip_smoke/``, decode them with the
   native loader (``use_native=True``), train the full-width bf16 frozen
   trunk with ``cache_trunk_features=True`` for three epochs of two
   64-clip batches (epoch 1 fills the device pool with 96 windows and the
   host tier with 32; epochs 2-3 run a device-tier and a mixed-tier step
   each), with the launch counts reset just before and read just after:
   the trunk runs 2, 0, 0 times, each step launches ``mfcc`` once,
   ``conv_chain`` 12 and its backward 29 times; the cached and the full
   frozen-trunk step agree; the host tier alone; f8 storage; the cache
   filled from the int8 trunk (36 ``qgemm_s8`` a fill batch, none after);
   a fresh trainer served from the disk tier without a trunk run; and
   ``Trainer.evaluate`` twice (the second pass from its cache) and
   uncached, with equal losses;
11. the generation workflow from the command line, on phase 10's shards, at
   full width, bf16, 64-clip batches, each pass with the launch counts reset
   just before and read just after (``mfcc`` and ``conv_chain`` in every
   one): ``cli.main.main(["--mode", "train", ...])`` for two epochs with the
   CLI defaults (``trunk_bn="train"``: 1 ``mfcc``, 12 ``conv_chain`` and 29
   backward launches a step, 1 and 12 a validation batch), then for three
   with ``--trunk_bn frozen --cache_trunk_features 1`` (the trunk runs for
   epoch 0's two training and two validation batches only), each run's
   files and a falling validation loss; a crash injected into epoch 1's
   loader, its ``epoch_interrupted_1.ckpt`` and position, and the resumed
   run against the uninterrupted one (run twice, to measure what the weight
   grad's atomics alone do); the checkpoint's size, synchronous and
   background write times and restore times, and its restore into a CPU
   task equal to the bit; ``--mode test --restore_checkpoint`` on the best
   epoch as a subprocess of ``python -m
   acoustic_image_generation_tpu_torch.cli.main``, against the same test in
   this process; ``tools iou`` (11 threshold files, the AUC) and ``tools
   generate --energy`` (shapes, finite values);
12. the classification family, at full width, bf16: ``sosfilt`` (the
   correspondence task's Butterworth filtfilt, a port-side kernel) against
   its plain version to the bit at 768 rows and at a ragged 77, and against
   SciPy's float64 ``sosfiltfilt``, timed beside its bounds; five 64-clip
   steps of each task through ``Trainer.train_step`` with the launch counts
   reset just before and read just after (DualCamNet on real images: no
   kernel; on the tiled MFCC map: 1 ``mfcc``; correspondence on outdoor
   data: 1 ``sosfilt`` and 1 ``mfcc``; on the frozen generator's images: 1
   ``mfcc``, 12 ``conv_chain``, no backward, no ``matmul_stats``), first and
   median step times, peak memory, a stage breakdown and one profiled step,
   the loss falling and the frozen tensors bit-frozen; two f32 steps of each
   on CUDA against the CPU; on phase 10's shards ``real_vs_generated_accuracy``,
   ``cli.main --mode train`` of the generated classifier for two epochs (the
   best epoch the most accurate) and ``--mode test`` on it;
13. TF1 checkpoints and the rest of the embedding family, at full width,
   bf16, on phase 10's shards, each pass with the launch counts reset just
   before and read just after: a generation checkpoint through ``tools
   export-tf1`` (numpy's reader and writer, no ``tensorflow``), read back
   bit-equal to the state, and the trunk and generator of a fresh task
   warm-started from the ``.ckpt`` bit-equal to it, then three 64-clip steps
   of that task (1 ``mfcc``, 12 ``conv_chain``, 29 backward launches each,
   the loss falling); the spectrogram statistics on the card (``stft``)
   against the CPU path, saved as ``stats2s``; ``cli.main --mode train
   --embedding 1 --normalize_spectrogram 1`` for two epochs of 32-clip
   batches with validation (1 ``stft``, 8 ``conv_chain`` and 19 backward
   launches a step, 1 and 8 a validation batch), ``--mode test`` of the best
   epoch, ``tools extract`` of the training and testing sets, ``tools knn``
   and ``retrieve`` with the card's distances against the CPU path's
   (equal), ``tools aggregate``, and ``tools export-tf1`` of the embed
   checkpoint warm-started back into a fresh ``EmbedTask``, bit-equal;
14. the reconstruction, projection and joint task families, at full width,
   bf16, on phase 10's shards: five steps of 32 one-second clips (the CLI's
   default batch) of each case, with the launch counts reset just before and
   read just after (reconstruction of acoustic frames, energy maps, the
   99x257 spectrogram and video frames; projection of the video latent
   with the triplet and with ``l2``, of the spectrogram through the audio
   encoder associator, and of both fused; the joint MVAE in its default,
   ``fusion``, ``onlyaudiovideo`` and ``moddrop`` modes), each with first
   and median step times, peak memory, a stage breakdown, the first batch's
   loss lower after the steps, every trained tensor moved and every frozen
   tensor and BN statistic bit-frozen; two f32 steps of one case of each
   family on CUDA against the CPU; from the command line, ``--model UNet
   --encoder_type Ac`` for two epochs and ``--mode test``, a joint task's
   weights through ``tools export-tf1`` (the associator skipped), a
   projection run warm-started from that TF1 ``.ckpt`` and a joint run
   warm-started from the projection's checkpoint (their VAEs bit-equal to
   the source), each with a falling validation MSE, ``--mode test``,
   ``tools extract`` and ``tools knn``;
15. serving artifacts, at full width, bf16, random weights from the seed:
   a generation artifact with its energy map (polymorphic batch), an int8
   one at a fixed batch of 96 frames (the unfused trunk), DualCamNet's, the
   embedding VAEs', a projection (``fusion``) and a joint
   (``onlyaudiovideo``) artifact, each exported (``core/serving.py``), its
   ``weights_sha256`` held to the digest of its trees, loaded on the card
   and served 32 96-frame (8-second) requests with the launch counts reset
   just before and read just after, with export and load seconds, bytes,
   first latency, the median and quartiles of the rest, and peak memory,
   the first request equal to the in-process service's on the same weights
   and seed to the bit; the generation artifact behind ``ArtifactServer``
   on 127.0.0.1 (the loaded model), 16 requests through ``ArtifactClient``
   equal to the direct calls' to the bit, with their median and quartiles
   beside the direct ones, and 400, 413 and 500 for
   a corrupt body, an 800 GB declared array and an injected model fault; an
   f32 generation artifact on the card against the CPU; ``tools
   export-serving`` of phase 11's checkpoint, ``serve-info`` and ``generate
   --artifact`` equal to ``generate`` from the checkpoint; the box sweep
   (``run_box_iou_sweep``) over box-annotated synthetic shards on the card
   (1 ``mfcc`` and 12 ``conv_chain`` a batch) against the CPU; the
   show-video device step on the card against the CPU; three steps of
   optax's Adam on the card equal to the CPU's to the bit on the same
   gradients, and the optimizer step's device time for it and TF1's Adam;
   two CLI epochs with ``optim.tf1_adam=False`` (optax's Adam), the
   validation MSE falling, and one resumed epoch;
16. the generation task on ranks (``parallel/mesh.py``), at full width,
   bf16, 64-clip global batches, 3 steps a case, each rank's launch counts
   reset just before its steps and read just after (1 ``mfcc``, 12
   ``conv_chain``, 29 backward a rank a step; 36 ``matmul_stats`` with
   ``fused_bn_stats``, 36 ``qgemm_s8`` int8): the kernels built once here,
   before any rank starts; one process, run twice, is the reference and its
   own spread (``conv_chain``'s dW atomics); one rank over NCCL through
   ``mesh.launch`` (DDP-wrapped, train-BN with ``fused_bn_stats`` and
   frozen), its step-1 loss equal to the one process's to the bit (the
   weight grad's atomics make later steps differ between any two runs),
   its updates and running averages held as the two ranks' below, its step
   median beside the plain trainer's; two ranks on the one card over gloo (NCCL
   refuses two ranks on one GPU), 32 clips each: DDP with train-BN and
   ``fused_bn_stats``, the int8 trunk (the ranks' amaxes equal to the one
   process's calibration) and FSDP (held to DDP, the Adam moments a rank
   printed), then DDP and FSDP in f32 on 4 clips of 2 frames, each rank's
   state equal to the other's, the losses within 1e-5 relative, each
   trained tensor's update held to the one process's (DDP, int8, f32) or
   DDP's (FSDP) by the CPU tests' trajectory bounds (every entry within 2
   lr, 99% within lr/4, 10% in L2: all three in f32; at bf16 the first,
   the others printed, since the split batch's own bf16 roundings go past
   them and past 3x the atomics' spread, printed beside it), the running
   averages within 3x that spread or 2^-5 (bf16; 1e-3 in f32) of
   how far they moved, step times marked "gloo, host-staged"; the
   cached path from phase 10's shards over 3 epochs through each rank's
   host-sharded loader, its fill steps against the uncached steps on the
   same rows, the trunk runs a rank an epoch; then the embedding task
   (default triplet, 32 clips) and the reconstruction task of each encoder
   type (32 clips; the video VAE 20, ``PAR_TASKS``), bf16, 3 steps of one
   fixed batch a case: one process; one rank over NCCL, step 1's loss
   equal to the plain trainer's to the bit; two ranks on the card over gloo
   under DDP and FSDP, the ranks' states and losses equal to each other's,
   each rank's launches a step equal to one process's (an embedding step 8
   ``conv_chain``, 19 backward, 1 ``stft``; ``Ac`` 8, 19; ``Energy`` 20,
   49; ``Audio`` 1 ``stft``), and against one process after step 1 the
   loss and its terms, the gradient (Adam's first moment) in L2 a VAE, the
   running averages and the updates (``PAR_TASK_LOSS_REL``,
   ``PAR_TASK_GRAD_TOL``), the later steps' losses (``PAR_TASK_LATER_REL``)
   and every update entry within 2 lr a step, each rank's peak memory
   printed; then DDP and FSDP in f32 of the embedding and ``Ac`` tasks on 4
   clips, held after step 1 to all three trajectory bounds but on the BN
   VAEs, ``Ac`` also after 3 (``PAR_F32_HELD``), beside two more
   one-process f32 embedding runs (again, and from weights one f32
   rounding away); with two or more cards, DDP and FSDP of the generation
   task over NCCL on up to four and ``cli.main --num_devices``;
17. raw captures (2 classes x 2 captures x 3 s of 12288 Hz wav, ``.dc``
   files; with Pillow BMP frames and small FlickrSoundNet, AVE and
   collected layouts) through the port's five converter tools in a
   subprocess that loads no CUDA code, the resharded audio read back by the
   C++ decoder bit-equal to the wavs (without Pillow: the video refusal
   naming it, ``pil: absent``), one epoch of DualCamNet on the tiled MFCC
   map from ``cli.main`` over the converted training list (one ``mfcc``
   launch a step and validation batch), the TUT loader and its 440/219/512
   spectrogram on the card against the CPU, then in-process steps timed by
   ``utils.profiling.StepTimer``, two traced by ``profiling.trace`` and read
   by ``op_stats`` (the ``mfcc`` kernel among the device ops), and
   ``device_memory_stats``' peak;
18. print the card's name and power limit, one ``{"kernels": [...]}`` line
   (each kernel's launches also over phase 11's passes, ``workflow_launches``,
   over phase 13's, ``embed_workflow_launches``, over phase 14's,
   ``task_families_launches``, over phase 15's, ``serving_launches``, over
   rank 0's runs of phase 16, ``parallel_launches``, and over phase 17's
   steps, ``convert_launches``), and last ``{"ok": true, "device": {...}}``.

f32 comparisons run with TF32 off for matmuls and cuDNN convolutions
(set in ``main``), so "f32" means IEEE f32 on both sides.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

FRAMES = 96  # one request: 8 clips x 12 frames
REQUESTS = 4
SEED = 0  # set from --seed in main
TRAIN_CLIPS = 64  # the JAX package's uncached train-step batch (bench.py)
TRAIN_FRAMES = 12 * TRAIN_CLIPS
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense, no TF32; float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12, torch.float64: 34e12}
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


def device_ms(fn, pattern: str, iters: int = 10) -> float:
    """Mean device time per call of ``fn`` spent in the CUDA kernels whose
    names match ``pattern``, by torch.profiler: a kernel's own time, without
    the wrapper's host work and the small torch ops around its launch."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and re.search(pattern, e.key))
    return us / iters / 1e3


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


def host_us(fn, iters: int = 200) -> float:
    """Host time per call of ``fn``, in us, without waiting for the card:
    what the wrapper costs the host, which bounds a stream of calls when it
    exceeds the kernel's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def kernel_times(fn, pattern: str) -> dict:
    """A call's time three ways: CUDA events per call (``ms``), the device
    time of its kernels matching ``pattern`` by the profiler
    (``device_ms``), and the host's time per call (``host_us``)."""
    return dict(ms=time_ms(fn), device_ms=device_ms(fn, pattern), host_us=host_us(fn))


def entry_times(kernel: dict, plain: dict, library: dict) -> dict:
    """A frontend kernel's times in its ``kernels`` entry: ``ms``,
    ``plain_ms`` and ``library_ms`` by CUDA events, as every entry's, and
    the profiler's device times beside them (``device_ms``,
    ``plain_device_ms``, ``library_device_ms``) with the wrapper's host us a
    call (``host_us``): these kernels run 5-10 us, under the host's time a
    call, so events over back-to-back calls read the host."""
    return dict(ms=kernel["ms"], plain_ms=plain["ms"], library_ms=library["ms"], device_ms=kernel["device_ms"],
                plain_device_ms=plain["device_ms"], library_device_ms=library["device_ms"],
                host_us=kernel["host_us"])


def frontend_times(kernel: dict, plain: dict, library_name: str, library: dict, bounds: dict) -> str:
    """One log line of a frontend kernel's times and bounds."""
    def ms(t):
        return f"{t['device_ms']:.4f} ms on the device ({t['ms']:.4f} by events, {t['host_us']:.1f} us of host)"

    return (f"kernel {ms(kernel)}; plain {ms(plain)}; {library_name} {ms(library)}; bound "
            f"{bounds['bound_ms']:.5f} ms ({bounds['bound_by']}; FFT, {bounds['nbytes'] / 1e6:.3f} MB, "
            f"{bounds['flops'] / 1e6:.2f} MFLOP) [DFT product: {bounds['dft_bound_ms']:.4f} ms]")


def tone_frames(rng, n: int) -> np.ndarray:
    """A loud tone over a quiet floor: in each frame a sine of amplitude
    20000 at a random frequency (20-400 cycles a frame) and phase, plus
    integer noise in [-1, 1], rounded to integers (tests/test_torch_mfcc.py
    draws the same)."""
    t = np.arange(1024)
    cycles = rng.uniform(20, 400, (n, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    x = 20000 * np.sin(2 * np.pi * cycles * t / 1024 + phase) + rng.integers(-1, 2, (n, 1024))
    return np.round(x).astype(np.float32)


def mfcc_bounds(n: int) -> dict:
    """Bounds of ``n`` frames: the FFT's (the function's bytes moved once:
    samples, outputs, and the window, the mel filters' nonzeros and the DCT
    in f32; the operations of what the kernel runs: window, 512-point FFT
    at 5 N log2 N, split, power, the mel spans, log and DCT, at the FP64
    peak) and, for comparison with the DFT kernel it replaced, the DFT
    product's (its two 4 MB f32 bases, at the f32 peak)."""
    from acoustic_image_generation_tpu_torch.dsp import mel

    nnz = int(np.count_nonzero(mel.create_filters()))
    io = n * (1024 + 12) * 4
    tables = (1024 + nnz + 24 * 12) * 4
    fft_ops = n * (1024 + 5 * 512 * 9 + 512 * 14 + 3 * 512 + 2 * nnz + 24 + 2 * 24 * 12)
    dft_bytes = io + (2 * 1024 * 512 + 512 * 24 + 24 * 12) * 4
    dft_ops = n * (2 * 2 * 1024 * 512 + 3 * 512 + 2 * 512 * 24 + 2 * 24 * 12)
    b, by = bound_ms(io + tables, fft_ops, torch.float64)
    return dict(bound_ms=b, bound_by=by, nbytes=io + tables, flops=fft_ops,
                dft_bound_ms=bound_ms(dft_bytes, dft_ops, torch.float32)[0])


def check_mfcc(mk) -> dict:
    """The ``mfcc`` kernel against its plain version at a request's 96
    frames, a train step's 768 and two ragged counts; times at 96 and 768
    frames beside the plain version, the ``torch.fft.rfft`` route and both
    bounds; then against a float64 witness (the host oracle) beside the
    plain version, on int16 noise and on a loud tone. Returns the 96-frame
    line of ``kernels``."""
    from acoustic_image_generation_tpu_torch.dsp import mel
    from acoustic_image_generation_tpu_torch.dsp.mfcc import device_constants, mfcc_numpy_oracle

    g = torch.Generator(device="cuda").manual_seed(SEED)
    errs = []
    for n in (FRAMES, TRAIN_FRAMES, 1000, 5):
        x = torch.randint(-(2**15), 2**15, (n, 1024), generator=g, device="cuda").float()
        errs.append(compare(f"mfcc n={n}", mk.mfcc(x), mk.mfcc_plain(x), MFCC_TOL))
    _, _, mel_b, dct_b = device_constants(torch.device("cuda", torch.cuda.current_device()))
    window = torch.from_numpy(mel.constants().window.astype(np.float32)).cuda()

    def library(x):
        # several calls: cuFFT's rfft, then the plain version's tail
        spec = torch.fft.rfft(x * window, dim=-1)[..., :mel.FFT_LEN]
        coeffs = torch.log(torch.clamp_min((spec.real.square() + spec.imag.square()) @ mel_b,
                                           mel.MELSPEC_FLOOR)) @ dct_b
        return torch.where(torch.isfinite(coeffs), coeffs, torch.zeros_like(coeffs))

    entry = None
    for n in (FRAMES, TRAIN_FRAMES):
        x = torch.randint(-(2**15), 2**15, (n, 1024), generator=g, device="cuda").float()
        compare(f"mfcc n={n}: the torch.fft.rfft route", library(x), mk.mfcc_plain(x), MFCC_TOL)
        t = kernel_times(lambda: mk.mfcc(x), "mfcc_kernel")
        plain = kernel_times(lambda: mk.mfcc_plain(x), ".")
        lib = kernel_times(lambda: library(x), ".")
        b = mfcc_bounds(n)
        log(f"time mfcc n={n}: " + frontend_times(t, plain, "torch.fft.rfft + tail", lib, b))
        if entry is None:
            entry = dict(
                name="mfcc", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/mfcc.cu",
                replaces="acoustic_image_generation_tpu/ops/pallas_mfcc.py:86",
                max_abs_err=max(errs), bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                **entry_times(t, plain, lib),  # library: torch.fft.rfft + the tail, several calls
            )
    rng = np.random.default_rng(SEED + 17)
    for what, frames in (("int16 noise", rng.integers(-(2**15), 2**15, (FRAMES, 1024)).astype(np.float32)),
                         ("a loud tone", tone_frames(rng, FRAMES))):
        x = torch.from_numpy(frames).cuda()
        witness = torch.from_numpy(mfcc_numpy_oracle(frames)).cuda()
        kernel, plain, lib = (float((f(x) - witness).abs().max()) for f in (mk.mfcc, mk.mfcc_plain, library))
        log(f"check mfcc against the float64 witness, {what}, n={FRAMES}: kernel {kernel:.3e}, plain "
            f"{plain:.3e} (limit: kernel at most 2x plain); the torch.fft.rfft route {lib:.3e}")
        if not kernel <= 2 * plain:
            raise AssertionError(f"mfcc on {what}: {kernel:.3e} off the float64 witness, plain {plain:.3e}")
    return entry


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
                        if tf32[kind] <= 2 * cudnn[kind]:
                            # cuDNN took no TF32 algorithm for this grad at these narrow
                            # channels (UNetEnergy's): its TF32 run is its f32 run, and
                            # excludes nothing
                            log(f"  {name} {kind}: cuDNN's TF32 run reads its f32 run's error; no TF32 "
                                "algorithm to exclude here")
                            continue
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


# the kernels a matmul_stats or qgemm_s8 call launches, by name
STATS_KERNELS = r"matmul_stats_(bf16|f32)|sum_partials"
QGEMM_KERNELS = r"qgemm_s8_kernel"
# (name, rows per frame, K, N) of three of the trunk's 1x1 stride-1 convs
STATS_SHAPES = (
    ("block1_unit_1.conv1", 55 * 74, 64, 64),
    ("block3_unit_1.conv3", 28 * 37, 256, 1024),
    ("block4_unit_1.shortcut", 14 * 19, 1024, 2048),
)


def check_matmul_stats(cs, task) -> dict:
    """The kernel against its plain version at three trunk shapes at the
    training batch, both dtypes; times in the task's dtype against
    ``torch.matmul`` followed by the two sums. Then the 36 launches of one
    768-frame ``fused_bn_stats`` trunk forward (``check_matmul_stats_trunk``)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0)
    err_main = 0.0
    for name, rows, k, n in STATS_SHAPES:
        m = TRAIN_FRAMES * rows
        for dt in (torch.bfloat16, torch.float32):
            x, w = stats_case(g, m, k, n, dt)
            err = check_stats_case(cs, f"{name} {str(dt)[6:]}", x, w)
            if dt != task.dtype:
                continue
            err_main = max(err_main, err)
            t = time_stats_case(cs, x, w, plain=True)
            log(f"time matmul_stats {name} ({m},{k})@({k},{n}): kernel {t['ms']:.3f} ms (device "
                f"{t['device_ms']:.3f}), plain "
                f"{t['plain_ms']:.3f} ms, matmul+sums {t['library_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), {t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s")
            for key in tot:
                tot[key] += t[key]
            del x, w
    b, by = bound_ms(tot["nbytes"], tot["flops"], task.dtype)
    check_matmul_stats_trunk(cs, task.dtype)
    return dict(
        name="matmul_stats", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/matmul_stats.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_conv_stats.py:114",
        max_abs_err=err_main, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b, bound_by=by,
        library_ms=tot["library_ms"],
    )


def stats_case(g, m, k, n, dt):
    """Operands of one ``matmul_stats`` shape: a post-ReLU input, as the
    trunk's 1x1 convs take, and fan-in scaled weights."""
    x = torch.relu(torch.randn((m, k), generator=g, device="cuda")).to(dt)
    w = (torch.randn((k, n), generator=g, device="cuda") / k**0.5).to(dt)
    return x, w


def check_stats_case(cs, name, x, w) -> float:
    """y within ``CHAIN_TOL`` of the plain version, both sums within 1e-4 of
    their largest entry; returns y's max abs error."""
    (m, k), n = x.shape, w.shape[1]
    y, s, ss = cs.matmul_stats(x, w)
    wy, ws, wss = cs.matmul_stats_reference(x, w)
    err = compare(f"matmul_stats {name} y ({m},{k})@({k},{n})", y, wy, CHAIN_TOL[x.dtype])
    e_s, e_ss = rel_err(s, ws), rel_err(ss, wss)
    log(f"check matmul_stats {name} sums: relative errors sum {e_s:.2e}, sumsq {e_ss:.2e} (tol 1e-4)")
    if max(e_s, e_ss) > 1e-4:
        raise AssertionError(f"matmul_stats {name}: sums off by {max(e_s, e_ss)}")
    return err


def time_stats_case(cs, x, w, plain: bool, iters: int = 20) -> dict:
    """Kernel, plain (if asked) and library (``torch.matmul`` + two sums)
    times of one shape, with its bound."""
    (m, k), n = x.shape, w.shape[1]

    def library():
        y = torch.matmul(x, w)
        return y, y.sum(0, dtype=torch.float32), (y * y).sum(0, dtype=torch.float32)

    ms = time_ms(lambda: cs.matmul_stats(x, w), iters=iters)
    dev = device_ms(lambda: cs.matmul_stats(x, w), STATS_KERNELS)
    plain_ms = time_ms(lambda: cs.matmul_stats_reference(x, w), iters=5, warmup=1) if plain else 0.0
    lib = time_ms(library, iters=iters)
    flops = 2 * m * k * n + 3 * m * n
    nbytes = (m * k + k * n + m * n) * x.dtype.itemsize + 2 * n * 4
    b, by = bound_ms(nbytes, flops, x.dtype)
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=lib, flops=flops, nbytes=nbytes,
                bound_ms=b, bound_by=by)


def plan_note(kernel: str, m: int, k: int, n: int) -> str:
    """The launch plan of a trunk GEMM kernel, for the logs; empty for a
    checkout from before the plans (``--package-root``)."""
    try:
        from acoustic_image_generation_tpu_torch.ops import gemm_plan
    except ImportError:
        return ""
    p = gemm_plan.plan(kernel, m, k, n, torch.cuda.get_device_properties(0).multi_processor_count)
    return (f" (N tile {p.bn} x{p.n_tiles}, {p.stages} stages{', weight panel' if p.panel else ''}, "
            f"{p.blocks_m} blocks a tile)")


def check_matmul_stats_trunk(cs, dtype) -> dict:
    """``matmul_stats`` at every distinct shape of the 36 launches of one
    ``fused_bn_stats`` trunk forward at the training batch (the train-mode
    1x1 convs: the same 36 convs ``qgemm_s8`` runs in the int8 trunk), in
    the compute dtype: each held against its plain version (y and both
    sums); kernel, library and bound per launch, and summed over the 36."""
    from collections import Counter

    shapes = Counter((rows, k, n) for rows, k, n, _, _ in qgemm_launches())
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tot = dict(ms=0.0, device_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0, bound_ms=0.0)
    worst = 0.0
    for (rows, k, n), count in shapes.items():
        m = TRAIN_FRAMES * rows
        x, w = stats_case(g, m, k, n, dtype)
        worst = max(worst, check_stats_case(cs, f"trunk {str(dtype)[6:]}", x, w))
        t = time_stats_case(cs, x, w, plain=False)
        log(f"time matmul_stats trunk ({m},{k})@({k},{n}) x{count}{plan_note('matmul_stats', m, k, n)}: kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), matmul+sums {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), {t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s, "
            f"{t['nbytes'] / t['ms'] / 1e6:.1f} GB/s")
        for key in tot:
            tot[key] += t[key] * count
        del x, w
        torch.cuda.empty_cache()
    b, by = bound_ms(tot["nbytes"], tot["flops"], dtype)
    log(f"time matmul_stats one {TRAIN_FRAMES}-frame fused_bn_stats trunk forward ({sum(shapes.values())} "
        f"launches, {len(shapes)} distinct shapes): kernel {tot['ms']:.3f} ms (device {tot['device_ms']:.3f}), "
        f"matmul+sums "
        f"{tot['library_ms']:.3f} ms, bound {b:.3f} ms ({by}; {tot['nbytes'] / 1e9:.2f} GB, "
        f"{tot['flops'] / 1e12:.2f} TFLOP; per-launch bounds summed {tot['bound_ms']:.3f} ms); y worst "
        f"{worst:.3e}")
    return tot


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
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, ops=0.0, bound_ms=0.0)
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
            dev = device_ms(lambda: qg.qgemm_s8(x, w, factor, bias, out_amax, **kw), QGEMM_KERNELS, iters=iters)
            plain = time_ms(lambda: qg.qgemm_s8_reference(x, w, factor, bias, out_amax, **kw), iters=3, warmup=1)
            lib = time_ms(library, iters=3, warmup=1)
            nbytes = m * k + n * k + m * n * (2 if res else 1) + 8 * n
            ops = 2 * m * k * n
            b, by = bound_ms(nbytes, ops, torch.int8)
            log(f"time qgemm_s8 {frames} frames {name} x{count}{plan_note('qgemm_s8', m, k, n)}: kernel {ms:.4f} ms "
                f"(device {dev:.4f}), plain {plain:.4f} ms, _int_mm+epilogue {lib:.4f} ms, bound {b:.4f} ms ({by}), "
                f"{ops / ms / 1e9:.1f} TOPS, {nbytes / ms / 1e6:.1f} GB/s")
            for key, v in dict(ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib, nbytes=nbytes, ops=ops,
                               bound_ms=b).items():
                tot[key] += v * count
            del x, w, r, got, fb, w_kn
            torch.cuda.empty_cache()
        b, by = bound_ms(tot["nbytes"], tot["ops"], torch.int8)
        log(f"time qgemm_s8 one {frames}-frame trunk forward (36 launches): kernel {tot['ms']:.3f} ms (device "
            f"{tot['device_ms']:.3f}), plain "
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


def stft_bounds(seconds: int) -> dict:
    """Bounds of ``seconds`` of audio: the FFT's (the function's bytes moved
    once: samples, magnitudes and the f32 window; the operations of what the
    kernel runs: window, 256-point FFT at 5 N log2 N, split and magnitude
    per frame, at the FP64 peak) and, for comparison with the DFT kernel it
    replaced, the DFT product's (its f32 bases, at the f32 peak)."""
    from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec

    frames = seconds * spec.NUM_FRAMES
    io = (seconds * spec.SAMPLES_PER_SECOND + frames * spec.NUM_BINS) * 4
    tables = spec.FRAME_LENGTH * 4
    fft_ops = frames * (spec.FRAME_LENGTH + 5 * 256 * 8 + spec.NUM_BINS * (14 + 4))
    dft_bytes = io + 2 * spec.FRAME_LENGTH * spec.NUM_BINS * 4
    dft_ops = frames * spec.FRAME_LENGTH * spec.NUM_BINS * 2 * 2  # two GEMMs
    b, by = bound_ms(io + tables, fft_ops, torch.float64)
    return dict(bound_ms=b, bound_by=by, nbytes=io + tables, flops=fft_ops,
                dft_bound_ms=bound_ms(dft_bytes, dft_ops, torch.float32)[0])


def check_stft(st) -> dict:
    """The ``stft`` kernel against its plain version (TF32 off) at an
    embedding request's 8 seconds and a train step's 32, with a float64
    witness on the plain version's f32 bases beside it; times of kernel,
    plain version and the ``torch.stft`` yardstick (cuFFT) beside both
    bounds. Returns the 32-second line of ``kernels``."""
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
        t = kernel_times(lambda: st.stft(x), "stft_kernel")
        plain = kernel_times(lambda: st.stft_plain(x), ".")
        lib = kernel_times(library, ".")
        b = stft_bounds(seconds)
        log(f"time stft {seconds} s: " + frontend_times(t, plain, "torch.stft", lib, b))
    return dict(
        name="stft", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/stft.cu",
        replaces="acoustic_image_generation_tpu/ops/pallas_stft.py:77",
        max_abs_err=float((got - want).abs().max()), bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        **entry_times(t, plain, lib),
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
    """Device time of each stage of one embedding request, by CUDA events,
    and the host's time to reach each stage's end; each encoder stage
    includes its VAE head."""
    from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND, resize_frames
    from acoustic_image_generation_tpu_torch.ops.stft import stft

    names = ("upload", "stft", "resize", "acoustic encoder", "audio encoder", "video encoder")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    host = [0.0] * (len(names) + 1)

    def one_pass(mark):
        torch.cuda.synchronize()
        mark(0)
        ac, audio, video = (torch.from_numpy(a).cuda() for a in req)
        mark(1)
        spec = stft(audio.reshape(-1, SAMPLES_PER_SECOND))
        mark(2)
        spec = resize_frames(spec)[..., None]
        mark(3)
        for i, (model, x) in enumerate(((task.acoustic, ac[::12]), (task.audio, spec), (task.video, video[::12]))):
            model.vae(model.features(x))
            mark(4 + i)
        torch.cuda.synchronize()

    def timed(i):
        ev[i].record()
        host[i] = time.perf_counter()

    with torch.inference_mode():
        one_pass(timed)
        one_pass(timed)  # the one reported
        parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
        host_ms = {n: (host[i + 1] - host[i]) * 1e3 for i, n in enumerate(names)}
    log("stages of one embedding request (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {ev[0].elapsed_time(ev[-1]):.3f}; host ms to each stage's end: "
        + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items()))
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


# ----------------------------------------------------------------------------------------------
# Phase 10: cached-feature training from TFRecord shards (train/feature_cache.py, data/)

CACHE_DATA = dict(num_classes=8, videos_per_class=4, seconds_per_video=4)  # 128 one-second windows
CACHE_CLIPS = 64  # the JAX bench's cached-step batch
CACHE_EPOCHS = 3
WINDOW_BYTES = 12 * 14 * 19 * 2048 * 2  # one window's bf16 trunk features
CACHE_POOL = 96 * WINDOW_BYTES  # the device pool: 96 of the 128 windows
# The cached step against the full frozen-trunk step, bf16, from the same
# weights, batch and noise (the step's generator): the features are the
# same bits either way and the forward runs the same kernels, so the losses
# agree to the bit (read 0 on an H100); the trained tensors' updates differ
# where the conv_chain weight grad's f32 atomics sum in another order, which
# Adam turns into at most a +-lr step on entries whose gradient is at
# rounding-noise level. Limits: loss 1e-6 relative; every entry within 2 lr
# (read 0.003 lr); each tensor's update within 1e-2 in L2 (read 1.5e-6
# after the fill step, 9.3e-4 after the device-tier step).
CACHED_LOSS_TOL = 1e-6
CACHED_UPDATE_TOL = 1e-2
# f8 storage against exact storage, the first step's loss and its MSE term,
# relative: JAX's test's envelope for the loss. The L2 term dominates the
# loss, so the MSE term, which alone sees the features, is held too.
F8_LOSS_TOL = 0.05
EVAL_TOL = 1e-6  # evaluate: second (cached) pass and uncached pass against the first, relative


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def timing_summary(name: str, times: list) -> dict:
    """First and median of a tier's step times (host clock to the loss on
    the host), with clips/s at the median."""
    med = statistics.median(times)
    log(f"cached training {name} ({card()}): {len(times)} steps, first {times[0]:.2f} ms, median {med:.2f} ms, "
        f"{CACHE_CLIPS / med * 1e3:.1f} clips/s, all {[round(t, 2) for t in times]}")
    return dict(first=times[0], median=med, steps=len(times))


def cache_trainer(**config):
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    cfg = GenerationConfig(trunk_bn="frozen", seed=SEED, **config)
    return Trainer(GenerationTask(cfg, device="cuda").init_params(SEED))


def run_epochs(trainer, loader, epochs: int, label: str) -> dict:
    """``epochs`` passes of ``loader`` through ``Trainer.train_step``: per
    epoch the trunk runs, per tier the step times, and the losses."""
    state = trainer.init_state()
    runs, times, losses = [], {}, []
    for epoch in range(epochs):
        before = trainer.trunk_runs
        for raw in loader.batches(epoch):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, raw)
            losses.append(float(metrics["loss"]))  # synchronizes
            times.setdefault(trainer.last_tier, []).append((time.perf_counter() - t0) * 1e3)
            log(f"cached training {label} epoch {epoch + 1} step {state.step}: {trainer.last_tier} tier, "
                f"{times[trainer.last_tier][-1]:.2f} ms, loss {losses[-1]:.6g}")
        runs.append(trainer.trunk_runs - before)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"cached training {label}: losses {losses} not finite")
    return dict(state=state, trunk_runs=runs, times=times, losses=losses)


def check_cached_against_full(loader) -> None:
    """Two steps on one batch: the cached trainer fills its pool on the
    first (trunk, then the head on the stored features) and serves the
    second from it; the full frozen-trunk trainer runs the trunk in both.
    Same weights, noise (the step generators) and batch."""
    raw = next(iter(loader.batches(0)))
    cached = cache_trainer(cache_trunk_features=True, cache_device_bytes=CACHE_POOL)
    full = cache_trainer()
    init = {n: p.detach().clone() for n, p in full.task.named_parameters() if p.requires_grad}
    states = [cached.init_state(), full.init_state()]
    lr = full.cfg.learning_rate
    for step in range(2):
        (states[0], m_c), (states[1], m_f) = cached.train_step(states[0], raw), full.train_step(states[1], raw)
        l_c, l_f = float(m_c["loss"]), float(m_f["loss"])
        worst_entry = worst_norm = 0.0
        params_c = dict(cached.task.named_parameters())
        for n, p in full.task.named_parameters():
            if n not in init:
                continue
            d_full, d_cached = p.detach() - init[n], params_c[n].detach() - init[n]
            gap = (d_cached - d_full).float()
            worst_entry = max(worst_entry, float(gap.abs().max()) / lr)
            worst_norm = max(worst_norm, float(gap.norm() / d_full.float().norm().clamp_min(1e-30)))
        loss_err = abs(l_c - l_f) / abs(l_f)
        log(f"check cached vs full step {step + 1} ({cached.last_tier} tier; trunk runs cached "
            f"{cached.trunk_runs}, full {full.trunk_runs}): loss {l_c:.9g} vs {l_f:.9g}, relative error "
            f"{loss_err:.2e} (tol {CACHED_LOSS_TOL}); worst update gap {worst_entry:.3f} lr (tol 2), worst tensor "
            f"update gap {worst_norm:.3e} in L2 (tol {CACHED_UPDATE_TOL})")
        if not (loss_err <= CACHED_LOSS_TOL and worst_entry <= 2 and worst_norm <= CACHED_UPDATE_TOL):
            raise AssertionError("the cached step and the full frozen-trunk step differ")
    if (cached.trunk_runs, cached.last_tier) != (1, "device"):
        raise AssertionError(f"cached check: {cached.trunk_runs} trunk runs, last tier {cached.last_tier}")


def estimate_trunk_statistics(task, video) -> None:
    """Set each trunk BN's running statistics to the batch mean and
    variance of its input on ``video`` (normalized frames), in forward
    order, as a trained trunk's statistics normalize its activations. At
    their initial values (mean 0, variance 1) the BNs pass a random
    ResNet50's activations through unscaled, and they grow unit by unit."""
    from acoustic_image_generation_tpu_torch.models.layers import BatchNorm

    def hook(bn, args):
        x = args[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 1, 2)))
        bn.running_var.copy_(x.var(dim=(0, 1, 2), unbiased=False))

    hooks = [m.register_forward_pre_hook(hook) for n, m in task.resnet.named_modules()
             if isinstance(m, BatchNorm) and not n.startswith("conv_map")]
    try:
        with torch.no_grad():
            task.trunk_features(video)
    finally:
        for h in hooks:
            h.remove()


def check_f8_storage(loader) -> None:
    """``cache_features_dtype="f8_e4m3"``. The cast on the card equals the
    CPU's, on features of the repo's initial weights, which pass f8's range
    (JAX's cast, which the port matches, makes those NaN, so f8 storage
    needs a trunk whose features fit). Then, on a trunk with BN statistics
    estimated from the batch: the pool holds float8_e4m3fn, the first step's
    loss is within F8_LOSS_TOL of exact storage's from the same weights,
    the second step is served from the pool."""
    from acoustic_image_generation_tpu_torch.data.preprocess import normalize_video
    from acoustic_image_generation_tpu_torch.train import feature_cache as fc

    raw = next(iter(loader.batches(0)))
    video = normalize_video(torch.as_tensor(raw.video[:8]).reshape(-1, 224, 298, 3).cuda())
    exact = cache_trainer(cache_trunk_features=True, cache_device_bytes=CACHE_POOL)
    trainer = cache_trainer(cache_trunk_features=True, cache_device_bytes=CACHE_POOL // 2,
                            cache_features_dtype="f8_e4m3")
    with torch.no_grad():
        feat = trainer.task.trunk_features(video)
    got = fc.to_float8_e4m3fn(feat).view(torch.uint8).cpu()
    want = fc.to_float8_e4m3fn(feat.cpu()).view(torch.uint8)
    over = int((feat.abs() > fc.F8_OVERFLOW).sum())
    log(f"check f8 cast, CUDA vs CPU on {feat.numel()} bf16 features of the initial weights (largest "
        f"{float(feat.abs().max()):.4g}, {over} beyond {fc.F8_OVERFLOW}, NaN in f8): {int((got != want).sum())} "
        "differ (tol 0)")
    if not torch.equal(got, want):
        raise AssertionError("the f8 cast on the card differs from the CPU's")
    for t in (exact, trainer):
        estimate_trunk_statistics(t.task, video)
    with torch.no_grad():
        feat = trainer.task.trunk_features(video)
    _, m_exact = exact.train_step(exact.init_state(), raw)
    state, m1 = trainer.train_step(trainer.init_state(), raw)
    state, m2 = trainer.train_step(state, raw)
    pool = trainer.device_cache
    exact_loss = float(m_exact["loss"])
    err = abs(float(m1["loss"]) - exact_loss) / abs(exact_loss)
    err_mse = abs(float(m1["mse"]) - float(m_exact["mse"])) / abs(float(m_exact["mse"]))
    log(f"check f8 storage (BN statistics from the batch, features largest {float(feat.abs().max()):.4g}): pool "
        f"{pool.resident} windows of {pool.buf.dtype}, capacity {pool.buf.shape[0]} in {CACHE_POOL // 2 / 2**30:.3f} "
        f"GiB; first loss {float(m1['loss']):.9g} vs exact {exact_loss:.9g}, relative {err:.2e}, MSE "
        f"{float(m1['mse']):.9g} vs {float(m_exact['mse']):.9g}, relative {err_mse:.2e} (tol {F8_LOSS_TOL}); "
        f"second step {trainer.last_tier} tier, loss {float(m2['loss']):.9g}, trunk runs "
        f"{trainer.trunk_runs}")
    if pool.buf.dtype != torch.float8_e4m3fn or not max(err, err_mse) <= F8_LOSS_TOL or trainer.last_tier != "device" \
            or trainer.trunk_runs != 1 or not np.isfinite(float(m2["loss"])):
        raise AssertionError("f8 feature storage failed its checks")


def check_int8_fill(loader, qg, counters: dict) -> None:
    """The cache filled from the int8 trunk: 36 ``qgemm_s8`` launches per
    fill batch, none once the features are cached."""
    trainer = cache_trainer(cache_trunk_features=True, cache_device_bytes=CACHE_POOL, trunk_quant="int8",
                            fused_qgemm=True)
    for fn in counters.values():
        fn.launches = 0
    out = run_epochs(trainer, loader, 2, "int8 fill")
    fill_q = qg.qgemm_s8.launches
    log(f"check int8 fill: trunk runs per epoch {out['trunk_runs']}, qgemm_s8 {fill_q} launches over "
        f"{sum(out['trunk_runs'])} fill and {len(out['losses']) - sum(out['trunk_runs'])} cached steps "
        f"(expected 36 per fill batch), tiers {({k: len(v) for k, v in out['times'].items()})}")
    if out["trunk_runs"] != [2, 0] or fill_q != 36 * 2:
        raise AssertionError("int8-filled cache: wrong trunk runs or qgemm_s8 launches")


def check_disk_tier(loader, root: str) -> None:
    """A trainer with ``cache_disk_dir`` writes a batch's features through
    to disk; a fresh trainer over the same loader serves that batch from the
    store with no trunk run and the same loss."""
    losses, stores = [], []
    for i in range(2):
        trainer = cache_trainer(cache_trunk_features=True, cache_device_bytes=0, cache_disk_dir=root)
        trainer.attach_disk(loader)
        raw = next(iter(loader.batches(0)))
        t0 = time.perf_counter()
        _, metrics = trainer.train_step(trainer.init_state(), raw)
        losses.append(float(metrics["loss"]))
        disk = trainer.feature_cache.disk
        stores.append(disk.dir)
        log(f"check disk tier, trainer {i + 1}: {trainer.last_tier} step {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"trunk runs {trainer.trunk_runs}, store {len(disk)} windows, {disk.nbytes / 2**30:.3f} GiB, "
            f"loss {losses[-1]:.9g}")
        if trainer.trunk_runs != (1 if i == 0 else 0):
            raise AssertionError("disk tier: the second trainer ran the trunk")
    if stores[0] != stores[1] or abs(losses[1] - losses[0]) > CACHED_LOSS_TOL * abs(losses[0]):
        raise AssertionError(f"disk tier: stores {stores}, losses {losses}")


def check_evaluate(trainer, state, loader) -> None:
    """``Trainer.evaluate`` twice over the validation loader (the second
    pass from its eval cache, no trunk run), then once uncached: the
    losses agree."""
    runs = []
    for use_cache in (True, True, False):
        before = trainer.trunk_runs
        t0 = time.perf_counter()
        res = trainer.evaluate(state, loader, use_cache=use_cache)
        runs.append((trainer.trunk_runs - before, res))
        log(f"evaluate ({'cached' if use_cache else 'uncached'}): {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"trunk runs {runs[-1][0]}, " + ", ".join(f"{k} {v:.9g}" for k, v in res.items()))
    first = runs[0][1]
    err = max(abs(res[k] - first[k]) / abs(first[k]) for _, res in runs[1:] for k in first)
    log(f"check evaluate: trunk runs per pass {[r for r, _ in runs]}, largest relative gap {err:.2e} "
        f"(tol {EVAL_TOL})")
    if [r for r, _ in runs] != [2, 0, 2] or err > EVAL_TOL or not all(np.isfinite(list(first.values()))):
        raise AssertionError("evaluate: wrong trunk runs or losses differ")


@contextlib.contextmanager
def scratch_dir():
    """A fresh directory under ``build/chip_smoke/``, removed on exit."""
    import shutil
    import tempfile

    parent = REPO / "build" / "chip_smoke"
    parent.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=parent))
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_shards(root: Path) -> dict:
    """The 128 one-second synthetic shards of phases 10 and 11; their
    training, validation and testing lists each name all of them."""
    from acoustic_image_generation_tpu_torch.data import write_synthetic_dataset

    t0 = time.perf_counter()
    lists = write_synthetic_dataset(str(root / "data"), seed=SEED, **CACHE_DATA)
    log(f"wrote {np.prod(list(CACHE_DATA.values()))} one-second shards in {time.perf_counter() - t0:.1f} s")
    return lists


def cached_training(counters: dict, qg, lists: dict, root: Path) -> dict:
    """Phase 10: full-width bf16 training from TFRecord shards (``lists``)
    with the frozen-trunk feature cache. Decodes them with the native
    loader, trains CACHE_EPOCHS epochs (epoch 1 fills the device pool with
    96 windows and the host tier with 32; then each epoch is a device-tier
    and a mixed-tier step), with the launch counts of ``counters`` reset
    just before and read just after; then the host tier alone, the checks
    against the full step, f8 storage, the int8 fill, the disk tier (under
    ``root``) and ``evaluate``. Returns the launch counts."""
    from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, native

    t0 = time.perf_counter()
    ok = native.available()
    log(f"native ingest: built {ok} in {time.perf_counter() - t0:.2f} s ({native.library_path().name}); "
        f"{native.build_error() or 'no error'}")
    loader = AcousticImageDataLoader(lists["training"], "training", CACHE_CLIPS, shuffle=False,
                                     use_native=True)
    valid = AcousticImageDataLoader(lists["validation"], "validation", CACHE_CLIPS, use_native=True)
    t0 = time.perf_counter()
    clips = sum(b.valid for b in loader.batches(0))
    secs = time.perf_counter() - t0
    log(f"loader ({loader.decoder} decoder, {loader.num_io_threads} threads; {card()}): {clips} clips in "
        f"{secs:.3f} s, {clips / secs:.1f} clips/s")

    check_cached_against_full(loader)
    torch.cuda.empty_cache()

    trainer = cache_trainer(cache_trunk_features=True, cache_device_bytes=CACHE_POOL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    out = run_epochs(trainer, loader, CACHE_EPOCHS, "bf16")
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(out["losses"])
    fills = sum(out["trunk_runs"])
    tiers = {k: len(v) for k, v in out["times"].items()}
    per_step = {"mfcc": 1, "conv_chain": 12, "conv_chain_backward": 29, "qgemm_s8": 0}
    log(f"cached training bf16: trunk runs per epoch {out['trunk_runs']} (expected [2, 0, 0]), tiers {tiers}, "
        f"pool {trainer.device_cache.resident} windows, host {len(trainer.feature_cache)} windows, "
        f"launches over {steps} steps {launches} (expected {per_step} per step), peak device memory "
        f"{peak:.3f} GiB")
    if out["trunk_runs"] != [2, 0, 0] or tiers != {"fill": 2, "device": 2, "mixed": 2}:
        raise AssertionError("cached training: wrong trunk runs or tiers")
    for k, v in per_step.items():
        if launches[k] != v * steps:
            raise AssertionError(f"cached training {k}: {launches[k]} launches, expected {v * steps}")
    timing = {k: timing_summary(k, v) for k, v in out["times"].items()}
    first = next(iter(loader.batches(0)))  # resident in the pool
    profile(lambda: trainer.train_step(out["state"], first), "device-tier step")

    host = cache_trainer(cache_trunk_features=True, cache_device_bytes=0)
    out_h = run_epochs(host, loader, CACHE_EPOCHS, "host tier")
    if out_h["trunk_runs"] != [2, 0, 0] or set(out_h["times"]) != {"fill", "host"}:
        raise AssertionError("host-tier training: wrong trunk runs or tiers")
    timing["host"] = timing_summary("host", out_h["times"]["host"])
    del host, out_h
    torch.cuda.empty_cache()

    check_f8_storage(loader)
    torch.cuda.empty_cache()
    check_int8_fill(loader, qg, counters)
    torch.cuda.empty_cache()
    check_disk_tier(loader, str(root / "store"))
    check_evaluate(trainer, out["state"], valid)
    log(f"cached training ({card()}): peak device memory {peak:.3f} GiB, decode {clips / secs:.1f} clips/s, "
        + ", ".join(f"{k} {v['median']:.2f} ms ({CACHE_CLIPS / v['median'] * 1e3:.1f} clips/s)"
                    for k, v in timing.items()))
    return launches


# Phase 11: the generation workflow from the command line (core/config.py, cli/, train/checkpoint.py,
# Trainer.fit/test, evaluation/)

WORKFLOW_CLIPS = 64  # --batch_size: the JAX bench's step batch
# The mid-epoch resume against the uninterrupted run of the same seed, bf16
# on the card: the same batches, noise and steps, but the conv_chain weight
# grad sums with f32 atomics in another order each run, which Adam turns
# into at most a +-lr step on entries whose gradient is at rounding-noise
# level. Two uninterrupted runs of the same seed measure that alone: after
# four steps generator.dense.weight's update differed by 1.73e-2 in L2
# between them (an H100, 700 W), more than PR 8's 9.3e-4 after one step.
# Limits: every entry within 2 lr; each trained tensor's update (final -
# initial) within 3x the largest gap between the two uninterrupted runs in
# L2, and no less than RESUME_UPDATE_TOL.
RESUME_UPDATE_TOL = 2e-2
# The test subprocess's test_accuracy.txt (6 decimals) against the same
# test in this process, from the same checkpoint: the same kernels on the
# same inputs; relative 1e-4, plus the file's rounding.
TEST_MATCH_TOL = dict(rel=1e-4, abs=1e-6)


def workflow_flags(lists: dict, root: Path, exp_name: str, *extra) -> list:
    """``cli.main`` flags of the flagship at full width, bf16 (the CLI's
    defaults), 64-clip batches, on one card (``--num_devices 1``: unset, the
    CLI would take every visible card)."""
    return ["--embedding", "1", "--mfcc", "1", "--num_devices", "1", "--batch_size", str(WORKFLOW_CLIPS),
            "--seed", str(SEED),
            "--train_file", lists["training"], "--valid_file", lists["validation"],
            "--test_file", lists["testing"], "--checkpoint_dir", str(root / "runs"), "--exp_name", exp_name,
            "--device", "cuda", *extra]


class counted:
    """Launch counts of ``counters`` over a block: reset on entry, read on
    exit into ``self.launches``; raises unless each of ``need`` launched."""

    def __init__(self, counters: dict, what: str, need=("mfcc", "conv_chain")):
        self.counters, self.what, self.need = counters, what, need

    def __enter__(self):
        torch.cuda.synchronize()
        for fn in self.counters.values():
            fn.launches = 0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, *_):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.launches = {k: fn.launches for k, fn in self.counters.items()}
        if kind is None:
            log(f"{self.what}: {self.seconds:.2f} s, launches {self.launches}")
            missing = [k for k in self.need if not self.launches[k]]
            if missing:
                raise AssertionError(f"{self.what}: {missing} never launched")


def read_run(run_dir: Path, label: str) -> list:
    """The run's metrics.jsonl records, logged; raises unless the run's
    files are there and the validation loss fell."""
    for name in ("configuration.txt", "model.txt", "metrics.jsonl", "epoch_0.ckpt"):
        if not (run_dir / name).exists():
            raise AssertionError(f"{label}: no {name} in {run_dir}")
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        log(f"workflow {label} epoch {r['epoch']} ({card()}): {r['steps']} steps in {r['seconds']:.3f} s, "
            f"{r['clips_per_sec']:.1f} clips/s, train loss {r['train']['loss']:.6g}, valid mse "
            f"{r['valid']['mse']:.6g}")
    mse = [r["valid"]["mse"] for r in records]
    if not (all(np.isfinite(mse)) and mse[-1] < mse[0]):
        raise AssertionError(f"{label}: validation mse {mse} did not fall")
    return records


class FaultyLoader:
    """A loader whose epoch ``epoch`` raises after ``after`` batches."""

    def __init__(self, loader, epoch: int, after: int):
        self.loader, self.epoch, self.after = loader, epoch, after

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def batches(self, epoch: int = 0):
        for i, batch in enumerate(self.loader.batches(epoch)):
            if epoch == self.epoch and i == self.after:
                raise OSError("shard read failed (injected)")
            yield batch


def workflow_trainer(lists, root, exp_name, *extra):
    """What ``cli.main`` builds from ``workflow_flags``: the trainer of the
    restored-or-fresh task and the training and validation loaders."""
    from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args, make_loader, select_task
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    args = build_parser().parse_args(workflow_flags(lists, root, exp_name, *extra))
    config = config_from_args(args)
    trainer = Trainer(select_task(config, args.device), config)
    return trainer, make_loader(config, "training"), make_loader(config, "validation")


def update_gaps(init: dict, task, ref, lr: float) -> tuple[float, dict]:
    """Each trained tensor's update (final - ``init``) in ``task`` against
    ``ref``'s: the largest entry gap in lr, and per tensor the L2 gap over
    ``ref``'s update."""
    got = dict(task.named_parameters())
    worst_entry, norms = 0.0, {}
    for n, p in ref.named_parameters():
        if n in init:
            d_want, d_got = p.detach() - init[n], got[n].detach() - init[n]
            gap = (d_got - d_want).float()
            worst_entry = max(worst_entry, float(gap.abs().max()) / lr)
            norms[n] = float(gap.norm() / d_want.float().norm().clamp_min(1e-30))
    return worst_entry, norms


def check_crash_and_resume(lists: dict, root: Path, counters: dict):
    """Frozen trunk with the feature cache, two epochs of two steps: the
    uninterrupted run, twice (their gap is what the weight grad's atomics
    alone make); a run whose loader fails after one batch of epoch 1 (the
    crash checkpoint and its position); that run resumed from the crash
    checkpoint, held against the first uninterrupted run. Returns the
    resumed trainer and state."""
    from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt

    frozen = ("--trunk_bn", "frozen", "--cache_trunk_features", "1", "--num_epochs", "2")
    runs = []
    for name in ("whole", "again"):
        trainer, train, valid = workflow_trainer(lists, root, name, *frozen)
        init = {n: p.detach().clone() for n, p in trainer.task.named_parameters() if p.requires_grad}
        with counted(counters, f"workflow uninterrupted run ({name})"):
            runs.append((trainer, trainer.fit(train, valid)))
    (whole, want), (again, _) = runs
    crashed, train, valid = workflow_trainer(lists, root, "crashed", *frozen)
    try:
        with counted(counters, "workflow run that crashes"):
            crashed.fit(FaultyLoader(train, epoch=1, after=1), valid)
        raise AssertionError("the injected loader fault did not reach fit's caller")
    except OSError as e:
        log(f"workflow crash: {e!r}")
    path = Path(crashed.run_dir) / "epoch_interrupted_1.ckpt"
    meta = ckpt.load_resume_meta(str(path))
    if not path.exists() or meta != {"epoch": 1, "step_in_epoch": 1}:
        raise AssertionError(f"crash checkpoint {path}: exists {path.exists()}, position {meta}")
    resumed, train, valid = workflow_trainer(lists, root, "resumed", "--trunk_bn", "frozen",
                                             "--cache_trunk_features", "1", "--num_epochs", "1")
    t0 = time.perf_counter()
    state = resumed.restore(str(path), resumed.init_state())
    torch.cuda.synchronize()
    log(f"workflow restore of the crash checkpoint on the card: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    with counted(counters, "workflow resumed run"):
        state = resumed.fit(train, valid, state=state)
    lr = resumed.cfg.learning_rate
    entry, norms = update_gaps(init, resumed.task, whole.task, lr)
    entry_again, norms_again = update_gaps(init, again.task, whole.task, lr)
    top = sorted(norms, key=norms.get, reverse=True)[:4]
    limit = max(RESUME_UPDATE_TOL, 3 * max(norms_again.values()))
    log(f"check resume ({card()}): steps {state.step} vs {want.step} uninterrupted; worst update gap {entry:.3f} lr "
        f"(uninterrupted twice: {entry_again:.3f}; tol 2); largest tensor update gaps in L2, resumed vs "
        f"uninterrupted twice: " + ", ".join(f"{n} {norms[n]:.3e} vs {norms_again[n]:.3e}" for n in top)
        + f" (tol {limit:.3e}: 3x the runs' gap, at least {RESUME_UPDATE_TOL})")
    if state.step != want.step or entry > 2 or max(norms.values()) > limit:
        raise AssertionError("the resumed run and the uninterrupted one differ")
    del whole, again, crashed, want, runs
    return resumed, state


def check_checkpoint_io(trainer, state, root: Path) -> None:
    """The resumed state written synchronously and through the background
    writer (the time ``save`` blocks, the time ``close`` takes), restored on
    the card and into a CPU task: the CPU task's state equal to the card's
    to the bit."""
    from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
    from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    out = root / "io"
    want = ckpt.state_dict(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(str(out), "sync", state)
    sync_ms = (time.perf_counter() - t0) * 1e3
    saver = ckpt.AsyncCheckpointer()
    t0 = time.perf_counter()
    saver.save(str(out), "async", state)
    block_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    saver.close()
    close_ms = (time.perf_counter() - t0) * 1e3
    size = Path(path).stat().st_size
    if (out / "epoch_async.ckpt").read_bytes() != Path(path).read_bytes():
        raise AssertionError("the background writer's file differs from the synchronous one")
    t0 = time.perf_counter()
    trainer.restore(path, trainer.init_state())
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    cpu = Trainer(GenerationTask(trainer.task.cfg, device="cpu"), trainer.config)
    t0 = time.perf_counter()
    cpu_state = cpu.restore(path, cpu.init_state())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got = ckpt.state_dict(cpu_state)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict) and v:
                yield from flat(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), v

    got, want = dict(flat(got)), dict(flat(want))
    mismatched = [k for k in want if k not in got or not np.array_equal(got[k], want[k])]
    log(f"checkpoint ({card()}): {size / 2**20:.1f} MiB; synchronous write {sync_ms:.1f} ms; background writer: "
        f"save blocks {block_ms:.1f} ms, close {close_ms:.1f} ms; restore on the card {restore_ms:.1f} ms, "
        f"into a CPU task {cpu_ms:.1f} ms; leaves that differ on the CPU: {len(mismatched)} of {len(want)}")
    if mismatched or got.keys() != want.keys():
        raise AssertionError(f"the card's checkpoint restored on the CPU differs: {mismatched[:5]}")


def workflow(counters: dict, lists: dict, root: Path) -> dict:
    """Phase 11: the reference protocol through the port's command line at
    full width, bf16, 64-clip batches: ``main --mode train`` (train-mode
    trunk BN, two epochs; then the frozen trunk with the feature cache,
    three epochs, validation from the eval cache), a crash and its
    mid-epoch resume, the checkpoint's write and restore times and its CPU
    restore, ``main --mode test`` as a subprocess, and the ``iou`` and
    ``generate --energy`` tools. Every pass counts its launches. Returns the
    launch counts summed over the passes."""
    from acoustic_image_generation_tpu_torch.cli import main as cli
    from acoustic_image_generation_tpu_torch.cli import tools
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
    from acoustic_image_generation_tpu_torch.train.generation import GenerationTask

    total = dict.fromkeys(counters, 0)
    passes = []

    def run(what, fn) -> dict:
        with counted(counters, what) as c:
            fn()
        passes.append((what, c.seconds))
        for k, v in c.launches.items():
            total[k] += v
        return c.launches

    # two epochs of two 64-clip steps over 128 windows, each with two validation batches
    got = run("workflow train, trunk_bn=train",
              lambda: cli.main(workflow_flags(lists, root, "train_bn", "--mode", "train", "--num_epochs", "2")))
    want = dict(mfcc=4 + 4, conv_chain=12 * (4 + 4), conv_chain_backward=29 * 4)
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"train run launches {got}, expected {want}")
    read_run(root / "runs" / "train_bn", "trunk_bn=train")
    torch.cuda.empty_cache()

    trunk = []
    features = GenerationTask.trunk_features

    def counting(self, *a, **k):
        trunk.append(1)
        return features(self, *a, **k)

    GenerationTask.trunk_features = counting
    try:
        run("workflow train, frozen trunk, feature cache",
            lambda: cli.main(workflow_flags(lists, root, "frozen", "--mode", "train", "--num_epochs", "3",
                                            "--trunk_bn", "frozen", "--cache_trunk_features", "1")))
    finally:
        GenerationTask.trunk_features = features
    log(f"workflow frozen run: {len(trunk)} trunk runs (expected 4: two training and two validation batches, "
        "all in epoch 0)")
    if len(trunk) != 4:
        raise AssertionError("the frozen run's training or validation did not ride the feature cache")
    read_run(root / "runs" / "frozen", "frozen trunk, cached")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resumed, state = check_crash_and_resume(lists, root, counters)
    passes.append(("workflow crash and resume (four runs)", time.perf_counter() - t0))
    check_checkpoint_io(resumed, state, root)
    del resumed, state
    torch.cuda.empty_cache()

    run_dir = root / "runs" / "train_bn"
    best = run_dir / f"epoch_{BestTracker.read_best_epoch(str(run_dir))}.ckpt"
    flags = workflow_flags(lists, root, "train_bn")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "acoustic_image_generation_tpu_torch.cli.main", *flags,
                           "--mode", "test", "--restore_checkpoint", str(best)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    passes.append(("workflow test subprocess", time.perf_counter() - t0))
    log(f"workflow test subprocess: exit {proc.returncode} in {passes[-1][1]:.1f} s; {proc.stdout.strip()[-400:]}")
    if proc.returncode != 0:
        raise AssertionError(f"main --mode test failed: {proc.stderr[-2000:]}")
    text = (run_dir / "test_accuracy.txt").read_text()
    written = dict(re.findall(r"(mse\d?): ([0-9.eE+-]+)", text))
    trainer, _, _ = workflow_trainer(lists, root, "train_bn")
    state = trainer.restore(str(best), trainer.init_state())
    from acoustic_image_generation_tpu_torch.cli.main import make_loader

    test_loader = make_loader(trainer.config, "testing")
    here = {}
    run("workflow test pass", lambda: here.update(trainer.test(state, test_loader)))
    gaps = {k: abs(float(written[k]) - v) for k, v in here.items()}
    log(f"check test subprocess against this process: {written} vs {here}")
    if written.keys() != here.keys() or any(g > TEST_MATCH_TOL["rel"] * abs(here[k]) + TEST_MATCH_TOL["abs"]
                                            for k, g in gaps.items()):
        raise AssertionError("the test subprocess and this process disagree")
    del trainer, state
    torch.cuda.empty_cache()

    iou_dir = root / "iou"
    run("workflow tools iou", lambda: tools.main(["iou", "--out_dir", str(iou_dir), str(best), "--", *flags]))
    names = sorted(p.name for p in iou_dir.iterdir())
    auc = float((iou_dir / "area.txt").read_text())
    log(f"workflow iou: AUC {auc:.6f}, files {names}")
    if len([n for n in names if n.startswith("intersection_")]) != 11 or not 0 <= auc <= 1:
        raise AssertionError("tools iou: wrong files or AUC")
    gen_dir = root / "generated"
    run("workflow tools generate --energy",
        lambda: tools.main(["generate", "--energy", str(best), str(gen_dir), "--", *flags]))
    images = np.load(gen_dir / "testing_generated.npy")
    energy = np.load(gen_dir / "testing_energy.npy")
    labels = np.load(gen_dir / "testing_labels.npy")
    n = int(np.prod(list(CACHE_DATA.values()))) * 12
    log(f"workflow generate: {images.shape} {images.dtype}, energy {energy.shape}, labels {labels.shape}")
    if (images.shape != (n, 36, 48, 12) or energy.shape != (n, 36, 48) or labels.shape != (n,)
            or not (np.isfinite(images).all() and np.isfinite(energy).all())):
        raise AssertionError("tools generate: wrong shapes or non-finite values")
    log(f"workflow ({card()}): " + ", ".join(f"{w} {s:.2f} s" for w, s in passes))
    return total


# ---------------------------------------------------------------- phase 12

FILTFILT_ROWS = TRAIN_FRAMES  # a 64-clip correspondence step's frames
FILTFILT_RAGGED = 77  # a row count that leaves the last block partly empty
# the kernel against SciPy's float64 sosfiltfilt, over the peak: twice the
# JAX package's own f32 gap (8.2e-5 over 16 int16-range frames, seed 0),
# as tests/test_torch_iir.py holds the plain version
FILTFILT_F64_TOL = 2 * 8.2e-5
CLASSIFY_TASKS = ("real", "mfccmap", "correspondence", "generated")
# launches of one step of each task: the correspondence batch's raw audio
# is not read (DualCamNet sees the acoustic image), so its one mfcc launch
# is the filtered audio's; the generated task's generator runs frozen, in
# eval mode: 12 forward conv_chain launches and no backward
CLASSIFY_PER_STEP = {
    "real": dict(mfcc=0, sosfilt=0, conv_chain=0, conv_chain_backward=0, matmul_stats=0),
    "mfccmap": dict(mfcc=1, sosfilt=0, conv_chain=0, conv_chain_backward=0, matmul_stats=0),
    "correspondence": dict(mfcc=1, sosfilt=1, conv_chain=0, conv_chain_backward=0, matmul_stats=0),
    "generated": dict(mfcc=1, sosfilt=0, conv_chain=12, conv_chain_backward=0, matmul_stats=0),
}


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi gives it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def check_sosfilt(sf) -> dict:
    """The ``filtfilt`` kernel (``csrc/sosfilt.cu``) against its plain
    version, to the bit, at a correspondence step's 768 rows of 1024 and at
    a ragged row count, and against SciPy's float64 ``sosfiltfilt``; times of
    kernel and plain version (no PyTorch call computes an IIR filter) beside
    the bounds: the bytes (each row read once and written once), the
    operations at the f32 peak, and the recurrence's dependency chain at the
    card's maximum SM clock (2 passes x 1090 steps x 5 sections x a
    dependent multiply and add of about 4 cycles each)."""
    import scipy.signal as sps

    from acoustic_image_generation_tpu_torch.dsp import iir

    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    sos64, _ = iir._default_sos(iir.SAMPLE_RATE, iir.DEFAULT_CUTOFF_HZ, iir.DEFAULT_ORDER)
    for rows in (FILTFILT_ROWS, FILTFILT_RAGGED):
        x = torch.randint(-(2**15), 2**15, (rows, 1024), generator=g, device="cuda").float()
        got = sf.filtfilt(x)
        t0 = time.perf_counter()
        want = sf.filtfilt_plain(x)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        witness = torch.from_numpy(np.ascontiguousarray(sps.sosfiltfilt(sos64, x.double().cpu().numpy(), axis=-1)))
        f64 = rel_err(got.cpu(), witness)
        same = torch.equal(got, want)
        log(f"check sosfilt {tuple(x.shape)}: kernel vs plain bit-equal {same} (max abs "
            f"{abs_err(got, want):.3e}); against float64 sosfiltfilt {f64:.3e} of the peak (tol "
            f"{FILTFILT_F64_TOL:.3e}), plain {rel_err(want.cpu(), witness):.3e}; one plain call {plain_s:.2f} s")
        if not same:
            raise AssertionError(f"sosfilt {rows} rows: kernel differs from its plain version")
        if not f64 <= FILTFILT_F64_TOL:
            raise AssertionError(f"sosfilt {rows} rows: {f64:.2e} of the peak from float64")
    x = torch.randint(-(2**15), 2**15, (FILTFILT_ROWS, 1024), generator=g, device="cuda").float()
    ms = time_ms(lambda: sf.filtfilt(x))
    dev = device_ms(lambda: sf.filtfilt(x), "filtfilt_kernel")
    plain_ms = time_ms(lambda: sf.filtfilt_plain(x), iters=2, warmup=1)
    steps = 1024 + 2 * iir.padlen()
    nbytes = 2 * x.numel() * 4
    flops = x.shape[0] * 2 * steps * sf.SECTIONS * 9  # 5 multiplies and 4 adds a section and step
    b, by = bound_ms(nbytes, flops, torch.float32)
    mhz = sm_clock_mhz()
    chain_ms = 2 * steps * sf.SECTIONS * 2 * 4 / (mhz * 1e6) * 1e3
    log(f"time sosfilt {tuple(x.shape)} ({card()}): kernel {ms:.4f} ms by events, {dev:.4f} ms on the device; "
        f"plain {plain_ms:.1f} ms; bound {b:.5f} ms ({by}; {nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP); "
        f"dependency chain {chain_ms:.4f} ms at {mhz:.0f} MHz; no library call")
    return dict(
        name="sosfilt", route="cuda", source="acoustic_image_generation_tpu_torch/csrc/sosfilt.cu",
        replaces="none: acoustic_image_generation_tpu/dsp/iir.py:192 (filtfilt_jax, a lax.scan)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
        device_ms=dev, chain_ms=chain_ms, clock_mhz=mhz,
    )


def classify_config(name: str, compute_dtype: str = "bfloat16", **over):
    from acoustic_image_generation_tpu_torch.train.classify import ClassifyConfig
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig

    kw = dict(compute_dtype=compute_dtype, seed=SEED)
    if name == "mfccmap":
        kw["mfccmap"] = True
    if name == "correspondence":
        kw["correspondence"] = True
    if name == "generated":
        kw["generation"] = GenerationConfig(compute_dtype=compute_dtype, seed=SEED)
    return ClassifyConfig(**kw, **over)


def classify_task(name: str, device: str, compute_dtype: str = "bfloat16", **over):
    """A full-width task of the classification family with ``init_params``'
    distributions from the seed (the generated task's ResNet50 3/4/6/3 and
    UNetAcResNet included)."""
    from acoustic_image_generation_tpu_torch.train import classify

    cls = {"real": classify.ClassificationTask, "mfccmap": classify.ClassificationTask,
           "correspondence": classify.CorrespondenceTask, "generated": classify.GeneratedClassificationTask}[name]
    return cls(classify_config(name, compute_dtype, **over), device=device).init_params(SEED)


def classify_batch(rng, clips):
    """Raw clips with their labels: 10 outdoor classes, 61 locations."""
    raw = train_batch(rng, clips)
    raw["action"] = rng.integers(0, 10, clips).astype(np.int32)
    raw["location"] = rng.integers(0, 61, clips).astype(np.int32)
    return raw


def classify_stages(trainer, state, raw, label) -> dict:
    """Device time of each stage of one classification train step, by CUDA
    events: the same calls as ``Trainer.train_step``, split where the events
    go (the generated task's trunk and generator apart)."""
    from acoustic_image_generation_tpu_torch.losses.classify import softmax_cross_entropy
    from acoustic_image_generation_tpu_torch.train.generation import no_tf32
    from acoustic_image_generation_tpu_torch.train.trainer import data_generator, step_generator

    task = trainer.task
    names = ("prepare", "trunk", "generator", "dualcamnet forward", "loss", "backward", "optimizer")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    generated = hasattr(task, "generation")
    with no_tf32():
        torch.cuda.synchronize()
        ev[0].record()
        batch = trainer._prepare(raw, generator=data_generator(SEED, state.step))
        ev[1].record()
        with torch.no_grad():
            feat = task.resnet(batch.video, mode="trunk") if generated else None
            ev[2].record()
            if generated:
                images = task.generation._forward(batch.mfcc, None, trunk_feat=feat,
                                                  generator=step_generator(SEED, state.step, "cuda")).output.float()
            else:
                images = task.inputs(batch)
        ev[3].record()
        logits = task.logits(images)
        ev[4].record()
        total = softmax_cross_entropy(task.labels(batch), logits)
        ev[5].record()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[6].record()
        state.optimizer.step()
        ev[7].record()
        torch.cuda.synchronize()
    state.step += 1
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    log(f"stages of one classification step {label} (device ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f", total {ev[0].elapsed_time(ev[-1]):.3f}")
    return parts


def train_classify(name: str, counters: dict) -> dict:
    """TRAIN_STEPS full-width bf16 steps of the task ``name`` on one fixed
    batch of TRAIN_CLIPS clips through ``Trainer.train_step``, the launch
    counts reset just before and read just after and held to
    CLASSIFY_PER_STEP. Checks: the loss falls, every DualCamNet tensor
    moves, the generated task's trunk, generator and BN statistics stay
    bit-frozen. Then a stage breakdown and one profiled step. Returns the
    launch counts."""
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    task = classify_task(name, "cuda")
    trainer = Trainer(task)
    state = trainer.init_state()
    raw = classify_batch(np.random.default_rng(SEED + 31), TRAIN_CLIPS)
    before = {n: t.detach().clone() for n, t in [*task.named_parameters(), *task.named_buffers()]}
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
        log(f"classify {name} step {state.step}: {times[-1]:.1f} ms, "
            + ", ".join(f"{k} {float(v):.6g}" for k, v in metrics.items()))
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: v * TRAIN_STEPS for k, v in CLASSIFY_PER_STEP[name].items()}
    log(f"classify {name}: launches over {TRAIN_STEPS} steps {launches} (expected {want})")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"classify {name}: launches {launches}, expected {want}")
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"classify {name} ({card()}): {TRAIN_CLIPS} clips x 12 frames a step, first step {times[0]:.1f} ms, "
        f"median of the next {TRAIN_STEPS - 1} {steady:.1f} ms, {TRAIN_CLIPS / steady * 1e3:.1f} clips/s, "
        f"peak device memory {peak:.3f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"classify {name} losses {losses}: not finite or not lower after the last step")
    moved, frozen_moved = 0, []
    for n, t in [*task.named_parameters(), *task.named_buffers()]:
        same = torch.equal(t.detach(), before[n])
        if n.startswith("dualcamnet."):
            if same:
                raise AssertionError(f"classify {name}: DualCamNet tensor {n} did not change")
            moved += 1
        elif not same:
            frozen_moved.append(n)
    if frozen_moved:
        raise AssertionError(f"classify {name}: frozen tensors changed: {frozen_moved[:3]}")
    log(f"classify {name} checks: losses {losses[0]:.6g} -> {losses[-1]:.6g}, {moved} DualCamNet tensors "
        f"changed, {len(before) - moved} frozen tensors bit-frozen, Adam slots for {len(state.optimizer.state)}")
    classify_stages(trainer, state, raw, name)
    profile(lambda: trainer.train_step(state, raw), f"classification step {name}")
    return launches


def check_classify_against_cpu(name: str) -> None:
    """Two f32 steps of one 12-frame clip on CUDA (kernels) and on the CPU
    (plain versions), from the same weights and non-zero biases; the
    generated task with the same VAE noise. Held as phase 6 holds the
    generation step: losses within 1e-4 relative; every DualCamNet entry's
    update within 2 lr of the CPU's, each tensor's within 10% in L2; the
    frozen tensors bit-frozen. The correspondence task takes the zeroed-video
    variant here: on the silence map the kernel's float64 MFCC of low-passed
    audio and the plain f32 one differ in the upper mel bands, which hold
    rounding noise (tests/test_torch_mfcc.py); its filtfilt is held to the
    bit above."""
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    raw = classify_batch(np.random.default_rng(SEED + 33), 1)
    eps = np.random.default_rng(SEED + 34).standard_normal((2, 12, 150)).astype(np.float32)
    over = {"correspondence_video": True} if name == "correspondence" else {}
    runs = []
    for dev in ("cuda", "cpu"):
        task = classify_task(name, dev, "float32", **over)
        randomize_biases(task, SEED + 35)
        init = {n: p.detach().cpu().clone() for n, p in task.named_parameters()}
        trainer = Trainer(task)
        state = trainer.init_state()
        losses = [float(trainer.train_step(state, raw, eps=e)[1]["loss"]) for e in eps]
        runs.append((losses, {n: p.detach().cpu() for n, p in task.named_parameters()}))
    (l_cuda, p_cuda), (l_cpu, p_cpu) = runs
    lr = task.cfg.learning_rate
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_cuda, l_cpu))
    worst_entry = worst_norm = 0.0
    for n, want in p_cpu.items():
        if not n.startswith("dualcamnet."):
            if not (torch.equal(p_cuda[n], init[n]) and torch.equal(want, init[n])):
                raise AssertionError(f"classify {name}: frozen parameter {n} changed")
            continue
        d_cuda, d_cpu = p_cuda[n] - init[n], want - init[n]
        gap = (d_cuda - d_cpu).abs()
        worst_entry = max(worst_entry, float(gap.max()) / lr)
        worst_norm = max(worst_norm, float(gap.norm() / d_cpu.norm().clamp_min(1e-30)))
    log(f"check classify {name} f32 cuda vs cpu (12 frames, 2 steps): losses {l_cuda} vs {l_cpu}, relative "
        f"error {loss_err:.2e} (tol 1e-4); worst update gap {worst_entry:.3f} lr (tol 2), worst tensor "
        f"update gap {worst_norm:.3e} in L2 (tol 0.1)")
    if not (loss_err <= 1e-4 and worst_entry <= 2 and worst_norm <= 0.1):
        raise AssertionError(f"classify {name}: CUDA and CPU train steps differ")


def classify_flags(lists: dict, root: Path, exp_name: str, *extra) -> list:
    """``cli.main`` flags of the generated classifier at full width, bf16,
    64-clip batches, on the card."""
    return ["--model", "DualCamNet", "--batch_size", str(WORKFLOW_CLIPS), "--seed", str(SEED),
            "--train_file", lists["training"], "--valid_file", lists["validation"],
            "--test_file", lists["testing"], "--checkpoint_dir", str(root / "runs"), "--exp_name", exp_name,
            "--device", "cuda", *extra]


def classification(counters: dict, lists: dict, root: Path) -> dict:
    """Phase 12: the classification family at full width, bf16, on the
    card. Five 64-clip steps of each task with launch counts, stage times
    and a profile; two f32 steps of each on CUDA against the CPU; on phase
    10's shards (class-dependent tones, 8 classes) the real-vs-generated
    accuracy, ``cli.main --mode train`` of the generated classifier for two
    epochs (the best epoch by validation accuracy) and ``--mode test`` on
    it. Returns the correspondence steps' launch counts (the path that runs
    ``sosfilt``)."""
    from acoustic_image_generation_tpu_torch.cli import main as cli
    from acoustic_image_generation_tpu_torch.cli.main import make_loader
    from acoustic_image_generation_tpu_torch.evaluation.real_vs_generated import real_vs_generated_accuracy
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    launches = {}
    for name in CLASSIFY_TASKS:
        launches[name] = train_classify(name, counters)
        torch.cuda.empty_cache()
    for name in CLASSIFY_TASKS:
        check_classify_against_cpu(name)
    torch.cuda.empty_cache()

    gen = GenerationTask(GenerationConfig(seed=SEED), device="cuda").init_params(SEED)
    cls = classify_task("real", "cuda")
    config = cli.config_from_args(cli.build_parser().parse_args(classify_flags(lists, root, "rvg")))
    with counted(counters, "real vs generated accuracy") as c:
        acc = real_vs_generated_accuracy(gen, cls, make_loader(config, "testing"), seed=SEED)
    log(f"real vs generated accuracy ({card()}): {acc} in {c.seconds:.2f} s")
    if not (acc["n"] == int(np.prod(list(CACHE_DATA.values())))
            and 0 <= acc["real_accuracy"] <= 1 and 0 <= acc["generated_accuracy"] <= 1):
        raise AssertionError(f"real_vs_generated_accuracy: {acc}")
    del gen, cls
    torch.cuda.empty_cache()

    # the generated classifier from the command line: two epochs of two
    # 64-clip steps, two validation batches each
    with counted(counters, "classify train, generated") as c:
        cli.main(classify_flags(lists, root, "generated", "--mode", "train", "--num_epochs", "2"))
    want = dict(mfcc=4 + 4, conv_chain=12 * (4 + 4), conv_chain_backward=0, sosfilt=0)
    if {k: c.launches[k] for k in want} != want:
        raise AssertionError(f"classify train launches {c.launches}, expected {want}")
    run_dir = root / "runs" / "generated"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        log(f"classify train epoch {r['epoch']} ({card()}): {r['steps']} steps in {r['seconds']:.3f} s, "
            f"{r['clips_per_sec']:.1f} clips/s, train loss {r['train']['loss']:.6g}, valid accuracy "
            f"{r['valid']['accuracy']:.4f}, cross-entropy {r['valid']['cross_loss']:.6g}")
    accs = [r["valid"]["accuracy"] for r in records]
    best = BestTracker.read_best_epoch(str(run_dir))
    if best != max(range(len(accs)), key=lambda e: (accs[e], e)):  # ">=": a tie goes to the later epoch
        raise AssertionError(f"classify train: best epoch {best} is not the most accurate of {accs}")
    ckpt_path = run_dir / f"epoch_{best}.ckpt"
    with counted(counters, "classify test, generated") as c:
        cli.main(classify_flags(lists, root, "generated", "--mode", "test", "--restore_checkpoint", str(ckpt_path)))
    text = (run_dir / "test_accuracy.txt").read_text()
    log(f"classify test: {text.strip()}; checkpoint {ckpt_path.stat().st_size / 2**20:.1f} MiB")
    if "accuracy" not in text or "cross_loss" not in text:
        raise AssertionError("classify test: no accuracy written")
    return launches["correspondence"]


# ---------------------------------------------------------------- phase 13

EMBED_FLOW_CLIPS = EMBED_CLIPS  # --batch_size of the embedding workflow: the JAX bench's embed batch
TF1_STEPS = 3  # bf16 64-clip steps of the warm-started generation task
# the spectrogram statistics on the card (the stft kernel) against the CPU
# path (its plain version) on the same batches: the spectrograms differ by
# at most STFT_TOL of the peak, and the sums are the same f32 numpy sums, so
# the mean within STFT_TOL of its largest entry and the variance (the std is
# the root of a difference of two sums, which cancels where a bin barely
# varies) within 2 STFT_TOL of the largest second moment, plus 1e-5 for the
# f32 sums (the CPU tests read 3.1e-7 between the plain version and JAX)
STATS_TOL = dict(mean=STFT_TOL, var=2 * STFT_TOL + 1e-5)


def flat_tree(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_tree(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def same_trees(got, want) -> list:
    """Leaves of ``want`` that ``got`` lacks or holds with other bits."""
    got, want = dict(flat_tree(got)), dict(flat_tree(want))
    return [k for k, v in want.items() if k not in got or got[k].tobytes() != v.tobytes()] + \
        [k for k in got if k not in want]


def tf1_round_trip(counters: dict, root: Path) -> dict:
    """The main path's TF1 round trip: a full-width generation checkpoint
    exported with ``tools export-tf1``, read back bit-equal to the state's
    tensors, the trunk and generator of a fresh task warm-started from it
    (``visual_init_checkpoint``, ``acoustic_init_checkpoint``) bit-equal to
    the source, then TF1_STEPS bf16 64-clip steps of that task with launch
    counts. Returns the steps' launches."""
    from acoustic_image_generation_tpu_torch import bridge
    from acoustic_image_generation_tpu_torch.cli import tools
    from acoustic_image_generation_tpu_torch.core import config as pconfig
    from acoustic_image_generation_tpu_torch.core import tf1_export, tf1_import
    from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
    from acoustic_image_generation_tpu_torch.train import warmstart
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    source = Trainer(GenerationTask(GenerationConfig(seed=SEED), device="cuda").init_params(SEED))
    state = source.init_state()
    ckpt_path = ckpt.save_checkpoint(str(root / "tf1"), "source", state)  # the JAX package's file format
    params, stats = bridge.to_flax(source.task)
    out = root / "tf1" / "flagship.ckpt"
    flags = ["--embedding", "1", "--mfcc", "1", "--seed", str(SEED), "--device", "cuda"]
    t0 = time.perf_counter()
    tools.main(["export-tf1", ckpt_path, str(out), "--", *flags])
    tool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tf1_export.export_state(params, stats, str(root / "tf1" / "again.ckpt"), global_step=state.step)
    export_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got = tf1_import.load_tf1_checkpoint(str(out))
    read_ms = (time.perf_counter() - t0) * 1e3
    want = {}
    for key, scope in (("resnet", "resnet_v1_50"), ("generator", "UNetAcRes")):
        want.update(tf1_export.export_scope({"params": params[key], "batch_stats": stats.get(key)}, scope,
                                            slim=key == "resnet"))
    want["global_step"] = np.asarray(state.step, np.int64)
    mib = sum(p.stat().st_size for p in out.parent.glob("flagship.ckpt.*")) / 2**20
    bad = [k for k in want if k not in got or got[k].tobytes() != want[k].tobytes()] + sorted(set(got) - set(want))
    log(f"tf1 export ({card()}): {len(got)} tensors, {mib:.1f} MiB; tools export-tf1 {tool_s:.2f} s (task, restore, "
        f"export), export {export_ms:.1f} ms, read {read_ms:.1f} ms; tensors that differ from the state's: {len(bad)}")
    if bad:
        raise AssertionError(f"the TF1 export read back differs: {bad[:5]}")

    fresh = Trainer(GenerationTask(GenerationConfig(seed=SEED), device="cuda").init_params(SEED + 1))
    fresh_state = fresh.init_state()
    conv_map = bridge.to_flax(fresh.task)[0]["resnet"]["conv_map"]
    run = pconfig.RunConfig(visual_init_checkpoint=str(out), acoustic_init_checkpoint=str(out))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmstart.apply_init_checkpoints(fresh_state, pconfig.ExperimentConfig(run=run))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    got_p, got_s = bridge.to_flax(fresh.task)
    trunk = lambda tree: {k: v for k, v in tree.items() if k != "conv_map"}
    bad = (same_trees(trunk(got_p["resnet"]), trunk(params["resnet"])) + same_trees(got_s, stats)
           + same_trees(got_p["generator"], params["generator"]) + same_trees(got_p["resnet"]["conv_map"], conv_map))
    log(f"tf1 warm start ({card()}): trunk and generator from the .ckpt in {warm_ms:.1f} ms (two imports of the "
        f"file); leaves not equal to the source's (conv_map: to the fresh task's): {len(bad)}")
    if bad:
        raise AssertionError(f"the .ckpt warm start differs from its source: {bad[:5]}")
    del source, state
    raw = train_batch(np.random.default_rng(SEED + 31), TRAIN_CLIPS)
    losses = []
    with counted(counters, f"tf1 warm-started train, {TF1_STEPS} steps",
                 need=("mfcc", "conv_chain", "conv_chain_backward")) as c:
        for _ in range(TF1_STEPS):
            t0 = time.perf_counter()
            fresh_state, metrics = fresh.train_step(fresh_state, raw)
            losses.append(float(metrics["loss"]))
            log(f"tf1 warm-started step {fresh_state.step}: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
                f"loss {losses[-1]:.6g}")
    want = dict(mfcc=TF1_STEPS, conv_chain=12 * TF1_STEPS, conv_chain_backward=29 * TF1_STEPS)
    if {k: c.launches[k] for k in want} != want or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"warm-started steps: launches {c.launches} (expected {want}), losses {losses}")
    return c.launches


def embed_flags(lists: dict, root: Path, *extra) -> list:
    """``cli.main`` flags of the embedding task at full width, bf16,
    EMBED_FLOW_CLIPS-clip batches, normalized spectrograms, on the card."""
    return ["--embedding", "1", "--batch_size", str(EMBED_FLOW_CLIPS), "--seed", str(SEED),
            "--normalize_spectrogram", "1", "--train_file", lists["training"], "--valid_file", lists["validation"],
            "--test_file", lists["testing"], "--checkpoint_dir", str(root / "runs"), "--exp_name", "embed",
            "--device", "cuda", *extra]


def check_spectrogram_stats(counters: dict, lists: dict):
    """The statistics of the training split on the card against the CPU
    path on the same batches, saved as ``stats2s`` beside the lists."""
    from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, stats

    loader = lambda: AcousticImageDataLoader(lists["training"], "training", EMBED_FLOW_CLIPS, seed=SEED)
    with counted(counters, "spectrogram statistics on the card", need=("stft",)) as c:
        mean, std = stats.compute_spectrogram_stats(loader(), device="cuda")
    t0 = time.perf_counter()
    cpu_mean, cpu_std = stats.compute_spectrogram_stats(loader(), device="cpu")
    cpu_s = time.perf_counter() - t0
    second = cpu_mean.astype(np.float64) ** 2 + cpu_std.astype(np.float64) ** 2
    mean_err = float(np.abs(mean - cpu_mean).max() / np.abs(cpu_mean).max())
    var_err = float(np.abs(std.astype(np.float64) ** 2 - cpu_std.astype(np.float64) ** 2).max() / second.max())
    log(f"spectrogram statistics ({card()}): {c.seconds:.2f} s on the card ({c.launches['stft']} stft launches), "
        f"{cpu_s:.2f} s on the CPU path; mean {mean_err:.2e} of its largest (tol {STATS_TOL['mean']}), variance "
        f"{var_err:.2e} of the largest second moment (tol {STATS_TOL['var']}); std {std.min():.4g}-{std.max():.4g}")
    if not (mean.shape == std.shape == (99, 257) and np.isfinite(mean).all() and np.isfinite(std).all()
            and mean_err <= STATS_TOL["mean"] and var_err <= STATS_TOL["var"]):
        raise AssertionError("the spectrogram statistics on the card differ from the CPU path's")
    stats.save_stats(str(Path(lists["training"]).parent / "stats2s"), mean, std)


def embed_workflow(counters: dict, lists: dict, root: Path) -> dict:
    """Phase 13: the TF1 round trip of the main path, the spectrogram
    statistics, and the embedding workflow from the command line at full
    width, bf16, on ``lists``: ``main --mode train --embedding 1`` (two
    epochs, validation, normalized spectrograms), ``--mode test`` of the
    best epoch, ``tools extract`` of the training and testing sets, ``tools
    knn`` and ``retrieve`` (the card's distances against the CPU path's:
    equal accuracy and ranks, and every row's neighbour list equal), ``tools aggregate``, and ``tools
    export-tf1`` of the embed checkpoint warm-started back into a fresh
    ``EmbedTask``, bit-equal. Every pass counts its launches. Returns the
    launch counts summed over the passes."""
    from acoustic_image_generation_tpu_torch import bridge
    from acoustic_image_generation_tpu_torch.cli import main as cli
    from acoustic_image_generation_tpu_torch.cli import tools
    from acoustic_image_generation_tpu_torch.core import config as pconfig
    from acoustic_image_generation_tpu_torch.evaluation.distance import as_feature_matrix, iter_nearest
    from acoustic_image_generation_tpu_torch.evaluation.export import load_features
    from acoustic_image_generation_tpu_torch.evaluation.knn import knn_accuracy
    from acoustic_image_generation_tpu_torch.evaluation.retrieve import RANKS, retrieval_ranks
    from acoustic_image_generation_tpu_torch.train import warmstart
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
    from acoustic_image_generation_tpu_torch.train.embed import EmbedTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    total = dict.fromkeys(counters, 0)
    passes = []

    def run(what, fn, need=("stft", "conv_chain")) -> dict:
        with counted(counters, what, need=need) as c:
            fn()
        passes.append((what, c.seconds))
        for k, v in c.launches.items():
            total[k] += v
        return c.launches

    phase = time.perf_counter()
    for k, v in tf1_round_trip(counters, root).items():
        total[k] += v
    torch.cuda.empty_cache()
    passes.append(("tf1 round trip and warm-started steps", time.perf_counter() - phase))
    check_spectrogram_stats(counters, lists)
    windows = int(np.prod(list(CACHE_DATA.values())))
    batches = -(-windows // EMBED_FLOW_CLIPS)

    got = run("embed train, 2 epochs", lambda: cli.main(embed_flags(lists, root, "--mode", "train", "--num_epochs", "2")),
              need=("stft", "conv_chain", "conv_chain_backward"))
    steps = 2 * (windows // EMBED_FLOW_CLIPS)
    want = dict(stft=steps + 2 * batches, conv_chain=8 * steps + 8 * 2 * batches, conv_chain_backward=19 * steps,
                mfcc=0)
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"embed train launches {got}, expected {want}")
    run_dir = root / "runs" / "embed"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        log(f"embed train epoch {r['epoch']} ({card()}): {r['steps']} steps in {r['seconds']:.3f} s, "
            f"{r['clips_per_sec']:.1f} clips/s, train loss {r['train']['loss']:.6g}, valid "
            + ", ".join(f"{k} {v:.6g}" for k, v in r["valid"].items()))
    if not all(np.isfinite(list(r["valid"].values())).all() and np.isfinite(r["train"]["loss"]) for r in records):
        raise AssertionError("embed train: non-finite losses")
    best_epoch = BestTracker.read_best_epoch(str(run_dir))
    best = run_dir / f"epoch_{best_epoch}.ckpt"
    run("embed test", lambda: cli.main(embed_flags(lists, root, "--mode", "test", "--restore_checkpoint", str(best))))
    text = (run_dir / "test_accuracy.txt").read_text()
    log(f"embed test: {text.strip()}")
    if "mse_audio" not in text:
        raise AssertionError("embed test: no losses written")

    feats = root / "features"
    for split in ("training", "testing"):
        run(f"embed tools extract --set {split}",
            lambda: tools.main(["extract", "--set", split, str(best), str(feats), "--", *embed_flags(lists, root)]))
    t0 = time.perf_counter()
    knn = {}
    for mod in ("acoustic", "audio", "video"):
        train_dir, test_dir = feats / f"training_{mod}_{best_epoch}", feats / f"testing_{mod}_{best_epoch}"
        tools.main(["knn", str(train_dir), str(test_dir)])
        knn[mod] = float((test_dir / "testing_knn_value.txt").read_text())
    anchor, gallery = feats / f"testing_acoustic_{best_epoch}", feats / f"testing_video_{best_epoch}"
    tools.main(["retrieve", "--num_classes", str(CACHE_DATA["num_classes"]), str(anchor), str(gallery)])
    ranks = json.loads((anchor / "testing_retrieval.txt").read_text())
    card_s = time.perf_counter() - t0
    passes.append(("embed tools knn (3) and retrieve on the card", card_s))
    t0 = time.perf_counter()
    cpu_knn = {}
    for mod in knn:
        tx, ty, _ = load_features(str(feats / f"training_{mod}_{best_epoch}"), "training")
        qx, qy, _ = load_features(str(feats / f"testing_{mod}_{best_epoch}"), "testing")
        cpu_knn[mod] = float(f"{knn_accuracy(tx, ty, qx, qy, device='cpu'):6f}")
    ax, ay, _ = load_features(str(anchor), "testing")
    gx, gy, _ = load_features(str(gallery), "testing")
    cpu_ranks = {k: v for k, v in retrieval_ranks(ax, ay, gx, gy, CACHE_DATA["num_classes"], device="cpu").items()
                 if k.startswith("rank")}
    cpu_s = time.perf_counter() - t0
    # the neighbour lists themselves, every row: the scalars above can agree while the distances do not
    pairs = {f"knn {m}": (feats / f"testing_{m}_{best_epoch}", feats / f"training_{m}_{best_epoch}", 15)
             for m in knn}  # the tools' k: knn_accuracy's 15 neighbours, retrieval's ranks up to 30
    pairs["retrieve"] = (anchor, gallery, max(RANKS))
    differ = {}
    for what, (qdir, gdir, k) in pairs.items():
        q = as_feature_matrix(load_features(str(qdir), qdir.name.split("_")[0])[0])
        g = as_feature_matrix(load_features(str(gdir), gdir.name.split("_")[0])[0])
        nearest = {dev: np.concatenate([idx for _, idx in iter_nearest(q, g, k, 2048, dev)]) for dev in ("cuda", "cpu")}
        rows = int(np.sum(np.any(nearest["cuda"] != nearest["cpu"], axis=1)))
        differ[what] = (rows, f"of {len(q)} rows of {k}, {q.shape[1]} dims")
    log(f"embed knn ({card()}): {knn} on the card, {cpu_knn} on the CPU path; retrieval {ranks} on the card, "
        f"{cpu_ranks} on the CPU path; {card_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; neighbour rows that "
        f"differ between the card and the CPU path (tol 0): {differ}")
    if knn != cpu_knn or ranks != cpu_ranks or any(rows for rows, _ in differ.values()):
        raise AssertionError("the card's kNN or retrieval differs from the CPU path's")
    agg = root / "aggregate.json"
    tools.main(["aggregate", *[str(feats / f"testing_{m}_{best_epoch}" / "testing_knn_value.txt") for m in knn],
                "--out", str(agg)])
    log(f"embed aggregate: {agg.read_text().strip()}")

    out = root / "tf1" / "embed.ckpt"
    t0 = time.perf_counter()
    tools.main(["export-tf1", str(best), str(out), "--", *embed_flags(lists, root)])
    export_s = time.perf_counter() - t0
    config = cli.config_from_args(cli.build_parser().parse_args(embed_flags(lists, root)))
    source = Trainer(EmbedTask(pconfig.embed_config(config), device="cuda"), config)
    source.restore(str(best), source.init_state())
    fresh = EmbedTask(pconfig.embed_config(config), device="cuda").init_params(SEED + 2)
    warm = pconfig.ExperimentConfig(run=pconfig.RunConfig(
        acoustic_init_checkpoint=str(out), audio_init_checkpoint=str(out), visual_init_checkpoint=str(out)))
    t0 = time.perf_counter()
    warmstart.apply_init_checkpoints(Trainer(fresh).init_state(), warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    got, want = bridge.to_flax(fresh), bridge.to_flax(source.task)
    bad = same_trees(got[0], want[0]) + same_trees(got[1], want[1])
    mib = sum(p.stat().st_size for p in out.parent.glob("embed.ckpt.*")) / 2**20
    log(f"embed tf1 ({card()}): {mib:.1f} MiB, tools export-tf1 {export_s:.2f} s, three scopes warm-started into "
        f"a fresh EmbedTask in {warm_s:.2f} s; leaves not equal to the checkpoint's: {len(bad)}")
    if bad:
        raise AssertionError(f"the embed TF1 round trip differs: {bad[:5]}")
    log(f"embed workflow ({card()}): " + ", ".join(f"{w} {s:.2f} s" for w, s in passes)
        + f"; launches over the passes {total}")
    return total


# ----------------------------------------------------------------------------------------------
# Phase 14: the reconstruction, projection and joint task families
# (train/reconstruct.py, train/project.py, train/joint.py, models/associators.py)

TASK_CLIPS = 32  # the CLI's default --batch_size: 32 one-second windows, 384 frames
# clips of the video VAE's reconstruction step: its peak read 27.61 GiB at 8
# clips (96 frames; about 3.9 GiB of masters, grads and Adam slots, then
# 0.247 GiB a frame), so the CLI's 32 clips (384 frames, about 99 GiB) do
# not fit on the 80 GB card; 20 clips (240 frames, about 63 GiB) leave room
VIDEO_RECON_CLIPS = 20
ENERGY_CHAINS = {"layer1": (36, 48), "layer2": (18, 24), "layer3": (9, 12), "layer4": (4, 4), "layer6": (9, 12),
                 "layer6_2": (9, 12), "layer7": (18, 24), "layer7_2": (18, 24), "layer8": (36, 48),
                 "layer8_2": (36, 48)}
# each case: (family, its configuration, launches a step) over TRAIN_STEPS steps
# of one fixed batch. conv_chain: 2 launches a chain forward; its backward in
# bf16 one gate a chain, one weight grad a layer and one data grad a layer but
# the first layer of a chain whose input needs no grad (the frozen acoustic
# decoder: its 2 chains, 10 launches).
FAMILY_CASES = {
    "reconstruct Ac": ("reconstruct", dict(encoder_type="Ac"), dict(stft=0, conv_chain=8, conv_chain_backward=19)),
    "reconstruct Energy": ("reconstruct", dict(encoder_type="Energy"),
                           dict(stft=0, conv_chain=20, conv_chain_backward=49)),
    "reconstruct Audio": ("reconstruct", dict(encoder_type="Audio"), dict(stft=1, conv_chain=0, conv_chain_backward=0)),
    "reconstruct Video": ("reconstruct", dict(encoder_type="Video"), dict(stft=0, conv_chain=0, conv_chain_backward=0)),
    "project Video": ("project", dict(encoder_type="Video"), dict(stft=0, conv_chain=8, conv_chain_backward=10)),
    "project Video l2": ("project", dict(encoder_type="Video", l2=True),
                         dict(stft=0, conv_chain=8, conv_chain_backward=10)),
    "project Audio": ("project", dict(encoder_type="Audio"), dict(stft=1, conv_chain=8, conv_chain_backward=10)),
    "project fusion": ("project", dict(fusion=True), dict(stft=1, conv_chain=8, conv_chain_backward=10)),
    "joint": ("joint", {}, dict(stft=1, conv_chain=8, conv_chain_backward=10)),
    "joint fusion": ("joint", dict(fusion=True), dict(stft=1, conv_chain=4, conv_chain_backward=10)),
    "joint onlyaudiovideo": ("joint", dict(onlyaudiovideo=True), dict(stft=1, conv_chain=8, conv_chain_backward=10)),
    "joint moddrop": ("joint", dict(moddrop=True), dict(stft=1, conv_chain=8, conv_chain_backward=10)),
}
# CUDA against the CPU, f32, two steps from the same weights, non-zero biases
# and noise: as phase 6 holds the generation step. The losses within 1e-4
# relative; every trained entry's update within 2 lr of the CPU's and each
# tensor's within 10% in L2 (Adam moves an entry whose gradient is at
# rounding-noise level by a full lr with whatever sign the noise gives it);
# the frozen tensors bit-frozen on both.
FAMILY_CPU_CASES = {"reconstruct Energy": 4, "project Video": 2, "joint": 2}  # frames or seconds


def family_task(family: str, config: dict, device: str, compute_dtype: str = "bfloat16"):
    """A full-width task of a family with ``init_params``' distributions from
    the seed."""
    from acoustic_image_generation_tpu_torch.train import joint, project, reconstruct

    cls, cfg = {"reconstruct": (reconstruct.ReconstructTask, reconstruct.ReconstructConfig),
                "project": (project.ProjectTask, project.ProjectConfig),
                "joint": (joint.JointTask, joint.JointConfig)}[family]
    return cls(cfg(compute_dtype=compute_dtype, seed=SEED, **config), device=device).init_params(SEED)


def family_noise(family: str, config: dict, rows: int, rng) -> dict | np.ndarray:
    """Noise of one step of a family's task as its ``loss`` takes it
    (``eps``), for ``rows`` frames or seconds."""
    from acoustic_image_generation_tpu_torch.train import joint, reconstruct

    if family == "reconstruct":
        return rng.standard_normal((rows, reconstruct.LATENTS[config["encoder_type"]])).astype(np.float32)
    if family == "project":
        return {k: rng.standard_normal((rows, 150)).astype(np.float32) for k in ("latent", "triplet")}
    return {k: rng.standard_normal((rows, d)).astype(np.float32) for k, d in joint.LATENTS.items()}


def family_batch(rng, clips, frames=12, amplitude=2**15):
    """Raw clips with labels: actions 0-3 in turn (several clips a class, so
    that the triplets have positives), location 0."""
    raw = embed_train_batch(rng, clips, amplitude) if frames == 12 else train_batch(rng, clips, frames)
    raw["action"] = (np.arange(clips) % 4).astype(np.int32)
    raw["location"] = np.zeros(clips, np.int32)
    return raw


def trained_names(task) -> set:
    return {n for n, p in task.named_parameters() if p.requires_grad}


def family_stages(trainer, state, raw, label) -> dict:
    """Device time of each stage of one train step, by CUDA events: the calls
    of ``Trainer.train_step``; "inputs" (the per-second frames and the STFT,
    or the energy maps) is timed alone and runs again inside "forward and
    loss"."""
    from acoustic_image_generation_tpu_torch.train.generation import no_tf32
    from acoustic_image_generation_tpu_torch.train.trainer import step_generator

    task = trainer.task
    names = ("prepare", "inputs", "forward and loss", "backward", "optimizer")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with no_tf32():
        torch.cuda.synchronize()
        ev[0].record()
        batch = trainer._prepare(raw)
        ev[1].record()
        with torch.no_grad():
            task.inputs(batch)
        ev[2].record()
        total, _ = task.loss(batch, generator=step_generator(SEED, state.step, "cuda"))
        ev[3].record()
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[4].record()
        state.optimizer.step()
        ev[5].record()
        torch.cuda.synchronize()
    state.step += 1
    parts = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    log(f"stages of one {label} step ({card()}, device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {ev[0].elapsed_time(ev[-1]):.3f}")
    return parts


def first_batch_terms(trainer, batch) -> dict:
    """The train-mode loss terms of ``batch`` with the draws of step 0, BN
    running averages put back: the same objective before and after the
    steps."""
    from acoustic_image_generation_tpu_torch.train.generation import no_tf32
    from acoustic_image_generation_tpu_torch.train.trainer import step_generator

    task = trainer.task
    saved = {n: b.clone() for n, b in task.named_buffers()}
    with torch.no_grad(), no_tf32():
        terms = {k: float(v) for k, v in task.loss(batch, generator=step_generator(SEED, 0, "cuda"))[1].items()}
        for n, b in task.named_buffers():
            b.copy_(saved[n])
    return terms


def train_family(name: str, counters: dict) -> dict:
    """TRAIN_STEPS full-width bf16 steps of the case ``name`` of
    FAMILY_CASES on one fixed batch (TASK_CLIPS clips; VIDEO_RECON_CLIPS for
    the video VAE's reconstruction), the launch counts reset just before and
    read just after and held to the case's. Checks: every loss term finite;
    the loss of the first step's batch and draws lower after the steps than
    before; every trained tensor moved; every frozen tensor and BN statistic
    bit-frozen, the trained BNs' statistics moved. Then a stage breakdown.
    Returns the launch counts."""
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    family, config, per_step = FAMILY_CASES[name]
    task = family_task(family, config, "cuda")
    trainer = Trainer(task)
    state = trainer.init_state()
    clips = VIDEO_RECON_CLIPS if name == "reconstruct Video" else TASK_CLIPS
    # where the loss holds the MSE against the spectrogram's raw magnitudes
    # (about 1e5 from int16-range samples, a loss of about 3e10 that f32 cannot
    # show five steps moving), quiet audio of samples in {-1, 0}
    quiet = name == "reconstruct Audio" or family == "joint" and "onlyaudiovideo" not in config
    raw = family_batch(np.random.default_rng(SEED + 41), clips, amplitude=1 if quiet else 2**15)
    trained = trained_names(task)
    before = {n: t.detach().clone() for n, t in [*task.named_parameters(), *task.named_buffers()]}
    terms_before = first_batch_terms(trainer, trainer._prepare(raw))
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
    launches = {k: fn.launches for k, fn in counters.items()}
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    steady = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{name} ({card()}): {clips} clips x 12 frames a step, first step {times[0]:.1f} ms, median of the next "
        f"{TRAIN_STEPS - 1} {steady:.1f} ms, {clips / steady * 1e3:.1f} clips/s, peak device memory {peak:.3f} GiB; "
        f"launches over {TRAIN_STEPS} steps {launches} (expected {want}); losses "
        + "; ".join(", ".join(f"{k} {v:.6g}" for k, v in step.items()) for step in losses))
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    if not all(np.isfinite(v) for step in losses for v in step.values()):
        raise AssertionError(f"{name}: a loss term is not finite")
    terms_after = first_batch_terms(trainer, trainer._prepare(raw))
    buffers = dict(task.named_buffers())
    trained_bn = {n for n in buffers if any(p.startswith(n.rsplit(".", 1)[0] + ".") for p in trained)}
    changed = {n for n, t in [*task.named_parameters(), *buffers.items()] if not torch.equal(t.detach(), before[n])}
    stayed = (trained | trained_bn) - changed
    frozen_moved = changed - trained - trained_bn
    log(f"{name} checks: the first batch's loss terms " + ", ".join(
        f"{k} {terms_before[k]:.9g} -> {terms_after[k]:.9g}" for k in terms_before) + f"; {len(trained)} trained "
        f"tensors and {len(trained_bn)} of their BN statistics, {len(stayed)} of them unchanged; "
        f"{len(before) - len(trained) - len(trained_bn)} frozen tensors and statistics, {len(frozen_moved)} of them "
        "changed")
    falls = terms_after["loss"] < terms_before["loss"]
    if family == "joint" and "onlyaudiovideo" not in config:
        # the associator reaches the reconstructions only through the frozen
        # VAEs' sampled heads and decoders, from random weights here: five
        # steps of lr 1e-4 move them below f32's resolution of the loss
        # (PERF.md); the KL term falls, and the loss must not rise
        falls = terms_after["loss"] <= terms_before["loss"] and terms_after["latent_loss"] < terms_before["latent_loss"]
    if not falls:
        raise AssertionError(f"{name}: the loss did not fall ({terms_before} -> {terms_after})")
    if stayed or frozen_moved:
        raise AssertionError(f"{name}: trained tensors that stayed {sorted(stayed)[:3]}, frozen tensors that "
                             f"changed {sorted(frozen_moved)[:3]}")
    family_stages(trainer, state, raw, name)
    return launches


def check_family_against_cpu(name: str) -> None:
    """Two f32 steps of the case ``name`` on CUDA and on the CPU, as
    FAMILY_CPU_CASES sizes it, from the same weights, non-zero biases and
    noise."""
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    family, config, _ = FAMILY_CASES[name]
    n = FAMILY_CPU_CASES[name]
    rng = np.random.default_rng(SEED + 43)
    # low-amplitude audio, so that the audio VAE's loss on raw magnitudes stays well conditioned
    raw = family_batch(rng, 1, n) if family == "reconstruct" else family_batch(rng, n, amplitude=4)
    eps = [family_noise(family, config, n, rng) for _ in range(2)]
    runs = []
    for dev in ("cuda", "cpu"):
        task = family_task(family, config, dev, "float32")
        randomize_biases(task, SEED + 45)
        init = {k: p.detach().cpu().clone() for k, p in task.named_parameters()}
        trainer = Trainer(task)
        state = trainer.init_state()
        losses = [float(trainer.train_step(state, raw, eps=e)[1]["loss"]) for e in eps]
        runs.append((losses, {k: p.detach().cpu() for k, p in task.named_parameters()}))
    trained = trained_names(task)
    (l_cuda, p_cuda), (l_cpu, p_cpu) = runs
    lr = task.cfg.learning_rate
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_cuda, l_cpu))
    worst_entry = worst_norm = 0.0
    for k, want in p_cpu.items():
        if k not in trained:
            if not (torch.equal(p_cuda[k], init[k]) and torch.equal(want, init[k])):
                raise AssertionError(f"{name}: frozen parameter {k} changed")
            continue
        d_cuda, d_cpu = p_cuda[k] - init[k], want - init[k]
        gap = (d_cuda - d_cpu).abs()
        worst_entry = max(worst_entry, float(gap.max()) / lr)
        worst_norm = max(worst_norm, float(gap.norm() / d_cpu.norm().clamp_min(1e-30)))
    log(f"check {name} f32 cuda vs cpu ({n} {'frames' if family == 'reconstruct' else 'seconds'}, 2 steps): "
        f"losses {l_cuda} vs {l_cpu}, relative error {loss_err:.2e} (tol 1e-4); worst update gap "
        f"{worst_entry:.3f} lr (tol 2), worst tensor update gap {worst_norm:.3e} in L2 (tol 0.1); "
        f"{len(p_cpu) - len(trained)} frozen tensors bit-frozen on both")
    if not (loss_err <= 1e-4 and worst_entry <= 2 and worst_norm <= 0.1):
        raise AssertionError(f"{name}: CUDA and CPU train steps differ")


def family_flags(lists: dict, root: Path, exp_name: str, *extra) -> list:
    """``cli.main`` flags at full width, bf16, TASK_CLIPS-clip batches (the
    CLI's defaults), on the card."""
    return ["--batch_size", str(TASK_CLIPS), "--seed", str(SEED), "--train_file", lists["training"],
            "--valid_file", lists["validation"], "--test_file", lists["testing"],
            "--checkpoint_dir", str(root / "runs"), "--exp_name", exp_name, "--device", "cuda", *extra]


FAMILY_FLAGS = {"recon": ("--model", "UNet", "--encoder_type", "Ac"),
                "project": ("--embedding", "1", "--project", "1", "--encoder_type", "Video"),
                "joint": ("--embedding", "1", "--jointmvae", "1")}


def family_workflow(counters: dict, lists: dict, root: Path) -> dict:
    """The three families from the command line, at full width, bf16, on
    ``lists``, each pass counting its launches: ``main --mode train --model
    UNet --encoder_type Ac`` (two epochs) and ``--mode test`` of its best
    epoch; a joint task's weights written and exported with ``tools
    export-tf1`` (the associator skipped), a projection run warm-started
    from that TF1 ``.ckpt`` (``--acoustic/visual/audio_init_checkpoint``),
    its VAEs bit-equal to the source; a joint run warm-started from the
    projection run's JAX-format checkpoint, bit-equal; for both, ``--mode
    test``, ``tools extract`` and ``tools knn`` on the latents. Every run's
    validation MSE falls. Returns the launch counts summed over the
    passes."""
    from acoustic_image_generation_tpu_torch import bridge
    from acoustic_image_generation_tpu_torch.cli import main as cli
    from acoustic_image_generation_tpu_torch.cli import tools
    from acoustic_image_generation_tpu_torch.core import tf1_format
    from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    total = dict.fromkeys(counters, 0)
    passes = []

    def run(what, fn, need=("conv_chain",)) -> dict:
        with counted(counters, what, need=need) as c:
            fn()
        passes.append((what, c.seconds))
        for k, v in c.launches.items():
            total[k] += v
        return c.launches

    windows = int(np.prod(list(CACHE_DATA.values())))
    steps, batches = 2 * (windows // TASK_CLIPS), 2 * -(-windows // TASK_CLIPS)  # 2 epochs, validation included
    per = {"recon": (dict(stft=0, conv_chain=8, conv_chain_backward=19), dict(stft=0, conv_chain=8)),
           "project": (dict(stft=0, conv_chain=8, conv_chain_backward=10), dict(stft=0, conv_chain=8)),
           "joint": (dict(stft=1, conv_chain=8, conv_chain_backward=10), dict(stft=1, conv_chain=8))}

    def train_run(kind, *extra):
        flags = family_flags(lists, root, kind, *FAMILY_FLAGS[kind])
        got = run(f"{kind} train, 2 epochs", lambda: cli.main(flags + ["--mode", "train", "--num_epochs", "2", *extra]),
                  need=("conv_chain", "conv_chain_backward"))
        step, val = per[kind]
        want = {k: step.get(k, 0) * steps + val.get(k, 0) * batches for k in step}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{kind} train launches {got}, expected {want}")
        run_dir = root / "runs" / kind
        read_run(run_dir, kind)
        best = run_dir / f"epoch_{BestTracker.read_best_epoch(str(run_dir))}.ckpt"
        run(f"{kind} test", lambda: cli.main(flags + ["--mode", "test", "--restore_checkpoint", str(best)]))
        log(f"{kind} test: {(run_dir / 'test_accuracy.txt').read_text().strip()}")
        return flags, best

    def extract_knn(kind, flags, best):
        feats = root / f"{kind}_features"
        for split in ("training", "testing"):
            run(f"{kind} tools extract --set {split}",
                lambda: tools.main(["extract", "--set", split, str(best), str(feats), "--", *flags]))
        epoch = best.name.split("_")[1].split(".")[0]
        knn = {}
        for mod in sorted(p.name[len("testing_"):-len(f"_{epoch}")] for p in feats.glob(f"testing_*_{epoch}")):
            test_dir = feats / f"testing_{mod}_{epoch}"
            tools.main(["knn", str(feats / f"training_{mod}_{epoch}"), str(test_dir)])
            knn[mod] = float((test_dir / "testing_knn_value.txt").read_text())
        log(f"{kind} knn ({card()}): {knn}")
        if not knn or not all(np.isfinite(list(knn.values()))):
            raise AssertionError(f"{kind}: no kNN accuracies")

    train_run("recon")

    # the warm-start source: a joint task's weights (the same three VAE shapes
    # as the projection task's), through tools export-tf1
    source = family_task("joint", {}, "cuda")
    src_path = ckpt.save_checkpoint(str(root / "src"), "source", Trainer(source).init_state())
    want = bridge.to_flax(source)
    del source
    torch.cuda.empty_cache()
    tf1 = root / "src" / "joint.ckpt"
    joint_flags = family_flags(lists, root, "source", *FAMILY_FLAGS["joint"])
    t0 = time.perf_counter()
    tools.main(["export-tf1", src_path, str(tf1), "--", *joint_flags])
    export_s = time.perf_counter() - t0
    scopes = {name.split("/")[0] for name in tf1_format.read_checkpoint(str(tf1))}
    mib = sum(p.stat().st_size for p in tf1.parent.glob("joint.ckpt.*")) / 2**20
    log(f"joint tf1 export ({card()}): {mib:.1f} MiB in {export_s:.2f} s, scopes {sorted(scopes)}")
    if scopes != {"UNetAcoustic", "UNet", "UNetAudio", "global_step"}:
        raise AssertionError(f"the joint export holds {sorted(scopes)}")
    warm = ["--acoustic_init_checkpoint", str(tf1), "--visual_init_checkpoint", str(tf1),
            "--audio_init_checkpoint", str(tf1)]
    flags, best = train_run("project", *warm)

    def frozen_equal(path, want, label):
        sd = ckpt.read_state_dict(str(path))
        bad = []
        for model in ("acoustic", "video", "audio"):
            bad += same_trees(sd["params"][model], want[0][model])
            if model in want[1]:
                bad += same_trees(sd["batch_stats"][model], want[1][model])
        log(f"{label}: the three VAEs of {path.name} against their source, leaves not equal: {len(bad)}")
        if bad:
            raise AssertionError(f"{label}: warm-started VAEs differ from their source: {bad[:5]}")
        return {k: sd[k] for k in ("params", "batch_stats")}

    project_vaes = frozen_equal(best, want, "project warm-started from TF1")
    extract_knn("project", flags, best)
    warm = ["--acoustic_init_checkpoint", str(best), "--visual_init_checkpoint", str(best),
            "--audio_init_checkpoint", str(best)]
    flags, joint_best = train_run("joint", *warm)
    frozen_equal(joint_best, (project_vaes["params"], project_vaes["batch_stats"]), "joint warm-started from JAX format")
    extract_knn("joint", flags, joint_best)
    log(f"task families workflow ({card()}): " + ", ".join(f"{w} {s:.2f} s" for w, s in passes)
        + f"; launches over the passes {total}")
    return total


def task_families(counters: dict, cc, lists: dict, root: Path, check_chains: bool) -> dict:
    """Phase 14: with ``check_chains`` (phase 14 run alone), ``conv_chain``
    forward and backward at UNetEnergy's chains at TASK_CLIPS x 12 frames
    against their plain versions, timed beside cuDNN; TRAIN_STEPS steps of
    each case of FAMILY_CASES; the CUDA-vs-CPU checks; the workflow from the
    command line. Returns the launch counts summed over the steps and the
    workflow's passes."""
    if check_chains:
        with torch.no_grad():
            check_energy_chains(cc)
    total = dict.fromkeys(counters, 0)
    for name in FAMILY_CASES:
        t0 = time.perf_counter()
        for k, v in train_family(name, counters).items():
            total[k] += v
        torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    for name in FAMILY_CPU_CASES:
        check_family_against_cpu(name)
        torch.cuda.empty_cache()
    for k, v in family_workflow(counters, lists, root).items():
        total[k] += v
    return total


def check_energy_chains(cc) -> tuple[float, float]:
    """``conv_chain`` forward and backward at the ten chains of UNetEnergy
    (1 to 32 input channels, 8 and 16 output) at TASK_CLIPS x 12 frames,
    against the plain versions, timed beside cuDNN. Returns the largest
    bf16 errors of the forward and the backward."""
    from acoustic_image_generation_tpu_torch.models.layers import init_modules
    from acoustic_image_generation_tpu_torch.models.unet_video import UNetEnergy

    energy = UNetEnergy(device="cuda")
    init_modules(energy, SEED + 46)
    chains = chain_layers(energy, ENERGY_CHAINS, 12 * TASK_CLIPS)
    err_f, fwd = check_conv_chain(cc, chains, torch.bfloat16)
    b, by = bound_ms(fwd["nbytes"], fwd["flops"], torch.bfloat16)
    log(f"time conv_chain UNetEnergy's ten chains at {12 * TASK_CLIPS} frames ({card()}): kernel {fwd['ms']:.4f} ms, "
        f"plain {fwd['plain_ms']:.4f} ms, cudnn {fwd['library_ms']:.4f} ms, bound {b:.4f} ms ({by})")
    err_b, bwd = check_conv_chain_backward(cc, chains, torch.bfloat16)
    b, by = bound_ms(bwd["nbytes"], bwd["flops"], torch.bfloat16)
    log(f"time conv_chain_backward UNetEnergy's ten chains at {12 * TASK_CLIPS} frames ({card()}): kernels "
        f"{bwd['ms']:.3f} ms, plain {bwd['plain_ms']:.3f} ms, cudnn autograd {bwd['library_ms']:.3f} ms, bound "
        f"{b:.4f} ms ({by}); by part " + ", ".join(f"{k} {v:.3f} ms" for k, v in bwd["parts"].items()))
    return err_f, err_b


# ----------------------------------------------------------------------------------------------
# Phase 15: serving artifacts (core/serving.py), their HTTP server and client (core/server.py,
# core/client.py), the artifact CLI, the box sweep (evaluation/localize_boxes.py), the renders'
# device step (evaluation/show_video.py) and optax's Adam (train/optim.py::Adam)

# each kind: launches a request of FRAMES frames (8 seconds for the kinds that take seconds). The
# generation artifacts take model-ready MFCC, so no mfcc launch; the int8 artifact serves the
# unfused trunk, so no qgemm_s8; the projection and joint artifacts decode the acoustic image
# alone (its decoder's 2 chains), the embedding artifact runs the encoders (the acoustic one's 2).
SERVING_REQUESTS = 32  # a kind's requests: inputs cycled over SERVING_INPUTS draws, a seed each
SERVING_INPUTS = 8
HTTP_REQUESTS = 16  # the generation artifact's first requests again, through HTTP
ADAM_STEPS = 20  # optimizer steps timed for each Adam
SERVING_KINDS = {
    "generation": dict(conv_chain=12),
    "generation int8": dict(conv_chain=12),
    "classification": {},
    "embedding": dict(stft=1, conv_chain=4),
    "projection": dict(stft=1, conv_chain=4),
    "joint": dict(stft=1, conv_chain=4),
}
# the box sweep CUDA against the CPU, f32, ae (no noise): as tests/test_torch_localize_boxes.py
# holds the port against JAX: each frame's IoU within 0.01 (a mask pixel at its map's mean may fall
# on the other side), the fractions and the AUC within 1/N of the N frames
BOX_IOU_TOL = 0.01
# the render step CUDA against the CPU, f32: the frames within 1e-6, the resized energy maps within
# 1e-2 relative: PATH_TOL's 1e-3 of the sigmoid output through find_logen's exponentials
RENDER_TOL = dict(video=1e-6, energy=1e-2)


def serving_inputs(kind: str, rng) -> tuple:
    """One request's model-ready float32 inputs for ``kind``."""
    video = rng.random((FRAMES, 224, 298, 3), dtype=np.float32)
    if kind.startswith("generation"):
        return rng.random((FRAMES, 12), dtype=np.float32), video
    if kind == "classification":
        return (rng.random((FRAMES, 36, 48, 12), dtype=np.float32),)
    audio = rng.integers(-(2**15), 2**15, (FRAMES, 1024)).astype(np.float32)
    if kind == "embedding":
        return rng.random((FRAMES, 36, 48, 12), dtype=np.float32), audio, video
    return audio, video


def serving_call(model, kind: str, inputs: tuple, seed: int) -> dict:
    """A served request as numpy outputs named as the manifest names them."""
    if kind.startswith("generation"):
        out = model.generate(*inputs, seed=seed)
        return dict(zip(model.manifest["outputs"], out if isinstance(out, tuple) else (out,)))
    if kind == "classification":
        return {"clip_logits": model.classify(*inputs)}
    if kind == "embedding":
        return {f"z_{k}": v for k, v in model.embed(*inputs, seed=seed).items()}
    return {"generated": model.project(*inputs, seed=seed)}


def in_process(task, kind: str, inputs: tuple, seed: int, qtrunk=None) -> dict:
    """The same request through the in-process service of ``task``, the
    artifact's source."""
    from acoustic_image_generation_tpu_torch import serving as services

    if kind.startswith("generation"):
        gen, energy = services.GenerationService(task, qtrunk).generate(*inputs, seed=seed)
        return {"generated": gen, "energy": energy}
    if kind == "classification":
        return {"clip_logits": services.ClassificationService(task)(*inputs)}
    if kind == "embedding":
        return dict(zip(("z_acoustic", "z_audio", "z_video"), services.EmbeddingService(task)(*inputs, seed=seed)))
    return {"generated": services.ProjectionService(task)(*inputs, seed=seed)}


def serving_source(kind: str):
    """The full-width bf16 task of ``kind`` with random weights from the seed,
    its export function and arguments, and its int8 trunk."""
    from acoustic_image_generation_tpu_torch.core import serving
    from acoustic_image_generation_tpu_torch.data.preprocess import normalize_video
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    if kind == "generation":
        return GenerationTask(GenerationConfig(), device="cuda").init_params(SEED), serving.export_generation, \
            dict(energy=True), None
    if kind == "generation int8":
        task = GenerationTask(GenerationConfig(trunk_bn="frozen", trunk_quant="int8"), device="cuda").init_params(SEED)
        video = torch.from_numpy(np.random.default_rng(SEED + 60).integers(0, 256, (FRAMES, 224, 298, 3),
                                                                          dtype=np.uint8)).cuda()
        qtrunk = task.build_qtrunk(normalize_video(video))
        return task, serving.export_generation, dict(qtrunk=qtrunk, batch=FRAMES), qtrunk
    if kind == "classification":
        return classify_task("real", "cuda"), serving.export_classification, {}, None
    if kind == "embedding":
        return embed_task("bfloat16", "cuda"), serving.export_embedding, {}, None
    if kind == "projection":
        return family_task("project", dict(fusion=True), "cuda"), serving.export_projection, {}, None
    return family_task("joint", dict(onlyaudiovideo=True), "cuda"), serving.export_joint, {}, None


def latency(times: list) -> dict:
    """Median, quartiles and range of request latencies (ms)."""
    q1, median, q3 = statistics.quantiles(times, n=4, method="inclusive")
    return dict(median=median, q1=q1, q3=q3, min=min(times), max=max(times))


def latency_text(rec: dict) -> str:
    return (f"median {rec['median']:.2f} ms, quartiles {rec['q1']:.2f}-{rec['q3']:.2f} ms, range "
            f"{rec['min']:.2f}-{rec['max']:.2f} ms")


def serve_artifact(kind: str, counters: dict, root: Path, total: dict) -> tuple[dict, object, list]:
    """Export ``kind``'s source task, check the manifest's weight digest
    against its trees, load the artifact on the card, serve SERVING_REQUESTS
    requests with the launch counts reset just before and read just after,
    and hold the first request against the in-process service (equal to the
    bit). Returns the record, the loaded model and the requests' inputs and
    outputs."""
    from acoustic_image_generation_tpu_torch import bridge
    from acoustic_image_generation_tpu_torch.core import serving

    task, export, kw, qtrunk = serving_source(kind)
    out_dir = root / "artifacts" / kind.replace(" ", "_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manifest = export(task, str(out_dir), **kw)
    export_s = time.perf_counter() - t0
    params, stats = bridge.to_flax(task)
    trees = (params,) if kind == "classification" else (params, stats, bridge.qtrunk_to_tree(qtrunk) if qtrunk else None)
    if manifest["weights_sha256"] != serving.params_digest(*trees):
        raise AssertionError(f"{kind}: the manifest's weights_sha256 is not the digest of the task's trees")
    del params, stats, trees
    t0 = time.perf_counter()
    model = serving.load_artifact(str(out_dir))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in out_dir.iterdir())
    rng = np.random.default_rng(SEED + 61)
    draws = [serving_inputs(kind, rng) for _ in range(SERVING_INPUTS)]
    reqs = [draws[i % SERVING_INPUTS] for i in range(SERVING_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    with counted(counters, f"serving {kind}: {SERVING_REQUESTS} artifact requests", need=()) as c:
        for i, inputs in enumerate(reqs):
            t0 = time.perf_counter()
            outs.append(serving_call(model, kind, inputs, SEED + i))
            times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in c.launches.items():
        total[k] += v
    want = {k: v * SERVING_REQUESTS for k, v in SERVING_KINDS[kind].items()}
    got = {k: v for k, v in c.launches.items() if v or k in want}
    if got != want:
        raise AssertionError(f"{kind}: launches {got} over {SERVING_REQUESTS} requests, expected {want}")
    for name, value in outs[0].items():
        if not np.isfinite(value).all():
            raise AssertionError(f"{kind}: {name} not finite")
    direct = in_process(task, kind, reqs[0], SEED, qtrunk)
    differ = [k for k in outs[0] if not np.array_equal(outs[0][k], direct[k].cpu().numpy())]
    if differ or set(direct) - set(outs[0]) - {"energy"}:
        raise AssertionError(f"{kind}: the artifact's {differ} differ from the in-process service's")
    rec = dict(export_s=export_s, load_s=load_s, bytes=nbytes, first=times[0], **latency(times[1:]), peak=peak,
               launches={k: v // SERVING_REQUESTS for k, v in got.items()})
    log(f"serving {kind} artifact ({card()}): export {export_s:.2f} s, load {load_s:.2f} s, {nbytes / 2**20:.1f} "
        f"MiB written; first request {rec['first']:.2f} ms, the next {SERVING_REQUESTS - 1}: "
        f"{latency_text(rec)}; "
        f"launches a request {rec['launches']}; peak {peak:.3f} GiB; outputs "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in outs[0].items())
        + "; equal to the in-process service's to the bit; weights_sha256 the trees' digest")
    del task, qtrunk, direct
    return rec, model, list(zip(reqs, outs))


def http_round_trip(model, served: list, direct: dict) -> dict:
    """The generation artifact behind ``ArtifactServer`` on 127.0.0.1, port
    0, holding the loaded model: HTTP_REQUESTS of the direct calls again
    through ``ArtifactClient``, their outputs equal to the direct calls' to
    the bit, their latencies beside the direct ones; a corrupt body 400, an
    oversized declared array 413, an injected model fault 500. Returns the
    HTTP latencies' ``latency`` record."""
    import io
    import urllib.error
    import urllib.request
    import zipfile

    from acoustic_image_generation_tpu_torch.core.client import ArtifactClient
    from acoustic_image_generation_tpu_torch.core.server import ArtifactServer

    server = ArtifactServer(model)
    server.start()
    url = f"http://{server.host}:{server.port}"
    try:
        client = ArtifactClient(url)
        if not client.healthy() or client.manifest != model.manifest:
            raise AssertionError("HTTP: the probes disagree with the loaded model")
        times = []
        for i, (inputs, want) in enumerate(served[:HTTP_REQUESTS]):
            t0 = time.perf_counter()
            got = client.generate(*inputs, seed=SEED + i)
            times.append((time.perf_counter() - t0) * 1e3)
            for name, value in zip(model.manifest["outputs"], got):
                if not np.array_equal(value, want[name]):
                    raise AssertionError(f"HTTP request {i}: {name} differs from the direct call's")

        def post(body: bytes) -> int:
            req = urllib.request.Request(f"{url}/call", data=body, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        npy = io.BytesIO()
        np.lib.format.write_array_header_1_0(npy, {"descr": "<f4", "fortran_order": False,
                                                    "shape": (10**6, 224, 298, 3)})
        zipped = io.BytesIO()
        with zipfile.ZipFile(zipped, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("video.npy", npy.getvalue() + bytes(4096))
        codes = {"corrupt body": post(b"not an npz archive" * 16), "declared 800 GB": post(zipped.getvalue())}
        generate = model.generate

        def fault(*a, **k):
            raise RuntimeError("injected fault")

        model.generate = fault
        try:
            buf = io.BytesIO()
            np.savez(buf, mfcc=served[0][0][0], video=served[0][0][1], seed=np.int32(SEED))
            codes["model fault"] = post(buf.getvalue())
        finally:
            model.generate = generate
    finally:
        server.shutdown()
    rec = latency(times[1:])
    log(f"HTTP ({card()}): {len(times)} generation requests through ArtifactClient equal to the direct calls to the "
        f"bit; first {times[0]:.2f} ms, the next {len(times) - 1}: {latency_text(rec)} (direct: "
        f"{latency_text(direct)}); status codes {codes}")
    if codes != {"corrupt body": 400, "declared 800 GB": 413, "model fault": 500}:
        raise AssertionError(f"HTTP status codes {codes}")
    return rec


def check_artifact_against_cpu(root: Path) -> None:
    """One f32 generation artifact (full width, non-zero biases) loaded on
    the card and on the CPU, two frames with the same noise: the outputs
    within the serving path's PATH_TOL."""
    from acoustic_image_generation_tpu_torch.core import serving
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    task = GenerationTask(GenerationConfig(compute_dtype="float32"), device="cpu").init_params(SEED)
    randomize_biases(task, SEED + 8)
    out_dir = str(root / "artifacts" / "generation_f32")
    serving.export_generation(task, out_dir, energy=True)
    rng = np.random.default_rng(SEED + 62)
    mfcc, video = rng.random((2, 12), dtype=np.float32), rng.random((2, 224, 298, 3), dtype=np.float32)
    eps = rng.standard_normal((2, 150)).astype(np.float32)
    outs = [serving.load_artifact(out_dir, device=dev).generate(mfcc, video, eps=eps) for dev in ("cuda", "cpu")]
    err = float(np.abs(outs[0][0] - outs[1][0]).max())
    rel_e = float((np.abs(outs[0][1] - outs[1][1]) / np.abs(outs[1][1])).max())
    log(f"check generation artifact f32 cuda vs cpu (2 frames): max_abs_err={err:.3e} (tol {PATH_TOL}), energy "
        f"max_rel_err={rel_e:.3e}")
    if not err <= PATH_TOL:
        raise AssertionError(f"the artifact on CUDA and on the CPU differ by {err}")


def box_sweep(counters: dict, root: Path, total: dict) -> None:
    """``run_box_iou_sweep`` over box-annotated synthetic shards (two videos
    of two seconds, batches of two windows) with a full-width f32 generator
    (``ae``: no noise; its last kernel scaled so that the energy maps vary),
    on the card (launches counted per batch) and on the CPU."""
    from acoustic_image_generation_tpu_torch.data.pipeline import AcousticImageDataLoader
    from acoustic_image_generation_tpu_torch.data.synthetic import write_flickr_dataset
    from acoustic_image_generation_tpu_torch.evaluation.localize_boxes import run_box_iou_sweep
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    lists = write_flickr_dataset(str(root / "flickr"), num_videos=2, seconds_per_video=2, seed=SEED)
    res = {}
    for dev in ("cuda", "cpu"):
        task = GenerationTask(GenerationConfig(ae=True, compute_dtype="float32"), device=dev).init_params(SEED)
        with torch.no_grad():
            task.generator.final.weight.mul_(30.0)
        loader = AcousticImageDataLoader(lists["testing"], "testing", 2, include_boxes=True)
        if dev == "cuda":
            with counted(counters, "box sweep on the card (2 batches)") as c:
                res[dev] = run_box_iou_sweep(task, loader, str(root / "boxes"), invert=True)
            for k, v in c.launches.items():
                total[k] += v
            per_batch = {k: v // 2 for k, v in c.launches.items() if v}
            if per_batch != {"mfcc": 1, "conv_chain": 12}:
                raise AssertionError(f"box sweep launches a batch {per_batch}")
        else:
            res[dev] = run_box_iou_sweep(task, loader, invert=True)
        del task
    got, want = res["cuda"], res["cpu"]
    n = len(want["iou"])
    gap = float(np.abs(got["iou"] - want["iou"]).max())
    frac_gap = max(abs(got["fractions"][t] - want["fractions"][t]) for t in want["fractions"])
    log(f"check box sweep cuda vs cpu ({n} frames): IoU max gap {gap:.3e} (tol {BOX_IOU_TOL}), IoU range "
        f"[{got['iou'].min():.4f}, {got['iou'].max():.4f}], fractions gap {frac_gap:.4f}, AUC {got['auc']:.6f} vs "
        f"{want['auc']:.6f} (tol 1/{n}); files {len(list((root / 'boxes').iterdir()))}")
    if (n != 48 or gap > BOX_IOU_TOL or frac_gap > 1 / n or abs(got["auc"] - want["auc"]) > 1 / n
            or not np.isfinite(got["iou"]).all()):
        raise AssertionError("the box sweep on the card and on the CPU differ")


def check_render_step() -> None:
    """The show-video device step (preprocess, forward, ``find_logen``,
    bilinear resize to 224x298) on the card against the CPU: full-width
    f32 generator, two frames, the same noise."""
    from acoustic_image_generation_tpu_torch.evaluation.show_video import video_overlay_step
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

    rng = np.random.default_rng(SEED + 63)
    raw = train_batch(rng, 1, 2)
    eps = rng.standard_normal((2, 150)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        task = GenerationTask(GenerationConfig(compute_dtype="float32"), device=dev).init_params(SEED)
        randomize_biases(task, SEED + 8)
        video, emap = video_overlay_step(task, raw, eps=torch.from_numpy(eps))
        outs.append((video.cpu(), emap.cpu()))
        del task
    v_err = float((outs[0][0] - outs[1][0]).abs().max())
    e_err = float(((outs[0][1] - outs[1][1]).abs() / outs[1][1].abs()).max())
    log(f"check show-video device step cuda vs cpu: frames {tuple(outs[0][0].shape)} max_abs_err={v_err:.3e} (tol "
        f"{RENDER_TOL['video']}), resized energy {tuple(outs[0][1].shape)} max_rel_err={e_err:.3e} (tol "
        f"{RENDER_TOL['energy']})")
    if outs[0][1].shape != (2, 224, 298) or v_err > RENDER_TOL["video"] or not e_err <= RENDER_TOL["energy"]:
        raise AssertionError("the render step on the card and on the CPU differ")


def artifact_cli(counters: dict, lists: dict, root: Path, checkpoint: str, total: dict) -> None:
    """``tools export-serving --energy`` of a generation checkpoint,
    ``serve-info``, and ``generate --energy --artifact`` against ``generate
    --energy`` from the checkpoint on the testing split: equal files."""
    from acoustic_image_generation_tpu_torch.cli import tools

    flags = workflow_flags(lists, root, "train_bn")
    art = root / "cli_artifact"
    runs = [("tools export-serving", ["export-serving", "--energy", checkpoint, str(art), "--", *flags], ()),
            ("tools serve-info", ["serve-info", str(art)], ()),
            ("tools generate --artifact", ["generate", "--energy", "--artifact", str(art), checkpoint,
                                           str(root / "gen_artifact"), "--", *flags], ("mfcc", "conv_chain")),
            ("tools generate", ["generate", "--energy", checkpoint, str(root / "gen_checkpoint"), "--", *flags],
             ("mfcc", "conv_chain"))]
    for what, argv, need in runs:
        with counted(counters, f"serving {what}", need=need) as c:
            rc = tools.main(argv)
        for k, v in c.launches.items():
            total[k] += v
        if rc != 0:
            raise AssertionError(f"{what} exited {rc}")
    for name in ("testing_generated.npy", "testing_energy.npy", "testing_labels.npy"):
        a, b = np.load(root / "gen_artifact" / name), np.load(root / "gen_checkpoint" / name)
        if not np.array_equal(a, b):
            raise AssertionError(f"generate --artifact and generate from the checkpoint differ in {name}")
    log(f"serving CLI: generate --artifact equals generate from the checkpoint ({a.shape[0]} images, energy "
        f"maps, labels)")


def adam_on_card() -> dict:
    """optax's Adam (``train/optim.py::Adam``) over the trainable tensors of
    the full-width generation task: three steps on the card and on the CPU
    from the same f32 parameters and gradients (seven decades of
    magnitude), the parameters and both moments equal to the bit; then one
    optimizer step's device time (CUDA events, the stream held behind a
    spin so that the host's launches run ahead of it, as in a train step)
    and host time (until ``step`` returns), medians of ADAM_STEPS, for it
    and for ``TF1Adam``. Returns ``{name: {"device": ms, "host": ms}}``."""
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.optim import Adam, TF1Adam

    task = GenerationTask(GenerationConfig(), device="cuda").init_params(SEED)
    cuda = [p.detach().clone().requires_grad_() for p in task.parameters() if p.requires_grad]
    del task
    host = [p.detach().cpu().requires_grad_() for p in cuda]
    rng = np.random.default_rng(SEED + 62)
    grads = [[torch.from_numpy(np.asarray(rng.standard_normal(p.shape) * 10.0 ** rng.uniform(-6, 1, p.shape),
                                          np.float32)) for p in host] for _ in range(3)]
    opts = Adam(cuda, 1e-4), Adam(host, 1e-4)
    for step in grads:
        for p, q, g in zip(cuda, host, step):
            p.grad, q.grad = g.cuda(), g.clone()
        for opt in opts:
            opt.step()
    for p, q in zip(cuda, host):
        a, b = opts[0].state[p], opts[1].state[q]
        for name, x, y in (("parameter", p, q), ("m", a["m"], b["m"]), ("v", a["v"], b["v"])):
            if not torch.equal(x.detach().cpu(), y.detach()):
                raise AssertionError(f"optax Adam on the card: a tensor's {name} differs from the CPU's after 3 steps")
    n = sum(p.numel() for p in cuda)
    times = {}
    for name, rule in (("adam", Adam), ("tf1_adam", TF1Adam)):
        opt = rule(cuda, 1e-4)
        for p, g in zip(cuda, grads[0]):
            p.grad = g.cuda()
        device, host = [], []
        for _ in range(ADAM_STEPS + 2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(100_000_000)  # about 50 ms of spinning: the step's launches queue behind it
            start.record()
            t0 = time.perf_counter()
            opt.step()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            device.append(start.elapsed_time(end))
        times[name] = dict(device=statistics.median(device[2:]), host=statistics.median(host[2:]))
    log(f"optax Adam on the card ({card()}): 3 steps over {len(cuda)} tensors ({n} f32 entries) equal to the CPU's "
        f"to the bit (parameters, m, v); one step, median of {ADAM_STEPS}, device / host ms: optax Adam "
        f"{times['adam']['device']:.3f} / {times['adam']['host']:.3f}, TF1 Adam {times['tf1_adam']['device']:.3f} / "
        f"{times['tf1_adam']['host']:.3f}")
    if max(t["host"] for t in times.values()) > 50:
        raise AssertionError("an optimizer step's launches outlasted the spin: its device time is the host's")
    return times


def optax_adam(counters: dict, lists: dict, root: Path, total: dict) -> None:
    """Two CLI epochs with ``optim.tf1_adam=False`` in the experiment
    configuration (the frozen trunk, 64-clip batches), the validation MSE
    falling; then the last epoch's checkpoint restored, the optimizer
    optax's with every slot at the run's step, and one more epoch that
    continues from it."""
    import dataclasses

    from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args, make_loader, select_task
    from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
    from acoustic_image_generation_tpu_torch.train.optim import Adam
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    def trainer_of(epochs):
        args = build_parser().parse_args(workflow_flags(lists, root, "optax_adam", "--trunk_bn", "frozen",
                                                        "--num_epochs", str(epochs)))
        config = config_from_args(args)
        config = dataclasses.replace(config, optim=dataclasses.replace(config.optim, tf1_adam=False))
        return Trainer(select_task(config, args.device), config), config

    trainer, config = trainer_of(2)
    with counted(counters, "serving optax Adam: two CLI epochs", need=("mfcc", "conv_chain")) as c:
        state = trainer.fit(make_loader(config, "training"), make_loader(config, "validation"))
    for k, v in c.launches.items():
        total[k] += v
    read_run(root / "runs" / "optax_adam", "optax Adam")
    if not isinstance(state.optimizer, Adam) or c.launches["conv_chain_backward"] == 0:
        raise AssertionError("the optax run did not train with optax's Adam")
    steps = state.step
    del trainer, state
    trainer, config = trainer_of(1)
    state = trainer.restore(str(root / "runs" / "optax_adam" / "epoch_1.ckpt"), trainer.init_state())
    if not isinstance(state.optimizer, Adam) or state.step != steps or ckpt.slot_count(state) != steps:
        raise AssertionError(f"the optax checkpoint restored at step {state.step}, expected {steps}")
    with counted(counters, "serving optax Adam: a resumed epoch") as c:
        state = trainer.fit(make_loader(config, "training"), make_loader(config, "validation"), state=state)
    for k, v in c.launches.items():
        total[k] += v
    log(f"optax Adam: two epochs to step {steps}, resumed to step {state.step}")
    if state.step != steps + steps // 2 or ckpt.slot_count(state) != state.step:
        raise AssertionError(f"the resumed optax run stopped at step {state.step}")


def serving_phase(counters: dict, lists: dict, root: Path, checkpoint: str) -> dict:
    """Phase 15: the six artifact kinds exported, loaded and served at full
    width, bf16, each with its times, bytes, launches, peak and the bit-equal
    check against the in-process service; HTTP round trips and error codes
    on the generation artifact; the f32 artifact CUDA against the CPU; the
    artifact CLI on ``checkpoint``; the box sweep and the render step CUDA
    against the CPU; optax's Adam on the card against the CPU, its step
    timed beside TF1's; optax's Adam from the command line. Returns the launch
    counts summed over the phase's passes."""
    total = dict.fromkeys(counters, 0)
    records = {}
    for kind in SERVING_KINDS:
        rec, model, served = serve_artifact(kind, counters, root, total)
        if kind == "generation":
            rec["http"] = http_round_trip(model, served, rec)
        records[kind] = rec
        del model, served
        torch.cuda.empty_cache()
    check_artifact_against_cpu(root)
    artifact_cli(counters, lists, root, checkpoint, total)
    box_sweep(counters, root, total)
    check_render_step()
    torch.cuda.empty_cache()
    records["optimizer step"] = adam_on_card()
    optax_adam(counters, lists, root, total)
    log(f"serving phase ({card()}): " + json.dumps(records))
    return total


# ------------------------------------------------------------ phase 16

PAR_CLIPS = 64  # the global batch: 32 clips a rank at two ranks
PAR_STEPS = 3
PAR_PER_STEP = {"mfcc": 1, "conv_chain": 12, "conv_chain_backward": 29}  # a rank's launches a step
PAR_CASES = {  # GenerationConfig of each case, and whether the trunk's 1x1 convs run on matmul_stats
    "train_bn": (dict(trunk_bn="train"), True),
    "frozen": (dict(trunk_bn="frozen"), False),
    "int8": (dict(trunk_bn="frozen", trunk_quant="int8", fused_qgemm=True), False),
    "cached": (dict(trunk_bn="frozen", cache_trunk_features=True), False),
    "f32": (dict(trunk_bn="train", compute_dtype="float32"), False),
}
PAR_LOSS_TOL = 1e-6  # a cached step against the uncached one on the same rows, relative
# running averages: within this share of how far the steps moved them, at least (3x the one-process spread
# otherwise). f32: the CPU tests' 1e-3. bf16: each rank's trunk runs its convolutions at half the batch, whose
# bf16 roundings differ and compound with depth (read on an H100 80GB HBM3 at 700 W, as a share of how far
# the average moved: 1.3e-3 at block3_unit_4, 6.1e-3 at block4_unit_3), so 2^-5 there; that both ranks hold
# the same averages, the f32 case and the CPU tests check the statistics are the global batch's.
PAR_STAT_FLOOR = {"bfloat16": 2.0**-5, "float32": 1e-3}
PAR_LR = 1e-4  # GenerationConfig's learning rate: the scale of one Adam step
# Ranks against one process, each trained tensor's update (final - initial), by tests/test_torch_train.py's
# trajectory criteria: every entry within 2 lr, 99% within lr/4, the whole within 10% in L2. In f32, at the
# same 64-clip global batch and full width, all three are held: there the split batch's roundings sit far below
# the gradients, so a wrong average (a sum, one rank's gradient) shows. At bf16 only the first is held and the
# others printed beside the same shares of the N=1 run against the plain trainer (the weight grad's atomics
# alone): each rank's convolutions run at half the batch (cuDNN picks its algorithms by shape) and the BN
# statistics add two partial sums, so bf16 roundings move, and Adam turns a gradient at rounding level into a
# full +-lr step (read on an H100 80GB HBM3 at 700 W: a bias's 99th percentile 1.4-1.5 of lr/4 and a dense
# kernel's L2 share 3.5, against 0.2-0.3 and 0.24-0.29 at N=1; in f32 at this batch 0.10 and 0.09).
PAR_UPDATE_TOL = dict(max=2 * PAR_LR, q99=PAR_LR / 4, l2=0.1)
PAR_RANK_CASES = ("ddp", "int8", "fsdp", "f32 ddp", "f32 fsdp", "uncached")  # par_ranks' par_steps runs
PAR_LOSS_REL = 1e-5  # each step's loss against one process, relative


def par_counters() -> dict:
    from acoustic_image_generation_tpu_torch.ops import conv_chain as cc
    from acoustic_image_generation_tpu_torch.ops import conv_stats as cs
    from acoustic_image_generation_tpu_torch.ops import mfcc_kernel as mk
    from acoustic_image_generation_tpu_torch.ops import qgemm as qg
    from acoustic_image_generation_tpu_torch.ops import stft as st

    return {"mfcc": mk.mfcc, "conv_chain": cc.conv_chain, "conv_chain_backward": cc.conv_chain_backward,
            "matmul_stats": cs.matmul_stats, "qgemm_s8": qg.qgemm_s8, "stft": st.stft}


def par_batches(seed: int, clips: int = PAR_CLIPS, frames: int = 12) -> list:
    """The PAR_STEPS global batches of ``clips`` clips; a rank keeps its
    rows."""
    from acoustic_image_generation_tpu_torch.parallel import mesh

    return [{k: mesh.shard_rows(v) for k, v in train_batch(np.random.default_rng(seed + 300 + s), clips,
                                                          frames).items()}
            for s in range(PAR_STEPS)]


def par_trainer(seed: int, case: str, fsdp: bool = False):
    from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, ParallelConfig
    from acoustic_image_generation_tpu_torch.models.resnet import ConvBN
    from acoustic_image_generation_tpu_torch.parallel import mesh
    from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    config, fused = PAR_CASES[case]
    task = GenerationTask(GenerationConfig(seed=seed, **config), device=mesh.device() or "cuda").init_params(seed)
    for m in task.resnet.modules():  # ResNet50(fused_bn_stats=True)
        if fused and isinstance(m, ConvBN) and m is not task.resnet.conv_map:
            m.fused_stats = not m.fixed_pad and m.weight.shape[2:] == (1, 1) and m.stride == 1
    return Trainer(task, ExperimentConfig(parallel=ParallelConfig(compute_dtype="bfloat16", fsdp=fsdp,
                                                                  num_devices=mesh.world())))


def par_tensors(task) -> dict:
    """The task's trained parameters and BN running averages as f32 CPU
    tensors (FSDP's shards gathered: every rank calls; buffers keyed
    ``buffer:<name>``)."""
    from acoustic_image_generation_tpu_torch.parallel import mesh

    copy = lambda t: t.detach().to("cpu", torch.float32, copy=True)
    return {**{n: copy(mesh.full(p)) for n, p in task.named_parameters() if p.requires_grad},
            **{"buffer:" + n: copy(b) for n, b in task.named_buffers()}}


def par_first(trainer, state, params: bool) -> dict:
    """What the first step left: each trained parameter's Adam first
    moment, keyed ``mu:<name>`` (TF1's Adam: 0.1 of the step's gradient),
    the BN running averages and, with ``params``, the parameters; FSDP's
    shards gathered (every rank calls)."""
    from acoustic_image_generation_tpu_torch.parallel import mesh

    out = {k: v for k, v in par_tensors(trainer.task).items() if params or k.startswith("buffer:")}
    for n, p in trainer.task.named_parameters():
        if p.requires_grad:
            out["mu:" + n] = mesh.full(state.optimizer.state[p]["m"], like=p).detach().to("cpu", torch.float32,
                                                                                          copy=True)
    return out


def par_run(trainer, batches: list, label: str = "", first: bool = False, first_params: bool = False,
            keep_init: bool = False) -> dict:
    """Train ``batches`` (this rank's rows) from the trainer's weights, the
    launch counts reset just before and read just after; returns the
    losses and metrics, step times, launches a step and in all, the trained
    tensors and BN running averages (FSDP's gathered) and their digest, the
    bytes of a rank's Adam moments, its count of sharded tensors and its
    peak memory; with ``first`` also what the first step left
    (``par_first``, with the parameters if ``first_params``), with
    ``keep_init`` the tensors the steps start from.
    Tensors come back from rank 0 only."""
    import hashlib

    from acoustic_image_generation_tpu_torch.parallel import mesh

    t_case = time.perf_counter()
    state = trainer.init_state()
    out = dict(init=par_tensors(trainer.task) if keep_init else None, first=None)
    counters = par_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, times, terms = [], [], []
    for raw in batches:
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, raw)
        losses.append(float(metrics["loss"]))  # synchronizes
        times.append((time.perf_counter() - t0) * 1e3)
        terms.append({k: float(v) for k, v in metrics.items()})
        if first and len(losses) == 1:
            out["first"] = par_first(trainer, state, first_params)
    total = {k: fn.launches for k, fn in counters.items()}
    tensors = par_tensors(trainer.task)
    h = hashlib.sha1()
    for t in tensors.values():
        h.update(t.contiguous().numpy())
    out.update(losses=losses, metrics=terms, times=times, total=total,
               launches={k: v / len(batches) for k, v in total.items()}, digest=h.hexdigest(),
               moments=sum(mesh.local(s["m"]).numel() * 2 * 4 for s in state.optimizer.state.values()),
               sharded=sum(mesh.is_sharded(p) for p in trainer.task.parameters()),
               peak=torch.cuda.max_memory_allocated() / 2**30, tensors=tensors)
    if not mesh.is_main():
        out.update(init=None, first=None, tensors=None)
    del state, tensors
    if label:
        log(f"parallel {label}: losses {[f'{v:.6g}' for v in losses]}, step ms {[round(t, 1) for t in times]}, "
            f"launches a step { {k: v for k, v in out['launches'].items() if v} }, Adam moments "
            f"{out['moments'] / 2**20:.1f} MiB, peak {out['peak']:.2f} GiB; {time.perf_counter() - t_case:.1f} s")
    return out


def par_steps(seed: int, case: str, batches: list, fsdp: bool = False, label: str = "") -> dict:
    """``par_run`` of a generation case from the seed's weights, with the
    int8 amaxes."""
    trainer = par_trainer(seed, case, fsdp)
    out = par_run(trainer, batches, label)
    out["amax"] = trainer.qtrunk.act.cpu().numpy() if trainer.qtrunk is not None else None
    del trainer
    torch.cuda.empty_cache()
    return out


def par_gap(a: dict, b: dict) -> float:
    """Largest |a - b| over the trained tensors."""
    return max(float((a[k] - b[k]).abs().max()) for k in a if ":" not in k)


def par_update_check(label: str, got: dict, want: dict, init: dict, held: int = 1, slack=None,
                     first_only=frozenset()) -> float:
    """Each trained tensor's update in ``got`` against ``want``'s, from
    ``init``, at PAR_UPDATE_TOL: the first ``held`` of its bounds (largest
    gap, 99th percentile, L2) held, the rest logged; ``slack(init)``, where
    given, replaces the largest gap's flat 2 lr entry by entry; the tensors
    in ``first_only`` are held to the first bound alone. Returns the worst
    share of a held bound."""
    worst, all_held, rest = (0.0, ""), (0.0, ""), [(0.0, "")] * 3
    for k, v in want.items():
        if ":" in k:  # buffers, moments
            continue
        d_want = v - init[k]
        gap = ((got[k] - init[k]) - d_want).abs().flatten()
        top = float((gap / slack(init[k].flatten())).max()) if slack else float(gap.max()) / PAR_UPDATE_TOL["max"]
        sample = gap[::-(-gap.numel() // (1 << 22))]  # the 99th percentile of at most 2^22 evenly strided entries
        q99 = float(sample.kthvalue(math.ceil(0.99 * sample.numel())).values)
        shares = (top, q99 / PAR_UPDATE_TOL["q99"],
                  float(gap.norm()) / max(PAR_UPDATE_TOL["l2"] * float(d_want.norm()), 1e-30))
        rest = [max(r, (x, k)) for r, x in zip(rest, shares)]
        worst = max(worst, (max(shares[:1 if k in first_only else held]), k))
        if k not in first_only:
            all_held = max(all_held, (max(shares[:held]), k))
    log(f"parallel {label}: updates at {worst[0]:.4f} of the held bounds ({worst[1]}); worst shares "
        + ", ".join(f"{name} {v:.4f} ({k})" for name, (v, k) in zip(("max", "99%", "L2"), rest))
        + f", the first {held} held" + (f"; {len(first_only)} tensors held to the first alone, the others at "
                                        f"{all_held[0]:.4f} ({all_held[1]})" if first_only else ""))
    if worst[0] > 1:
        raise AssertionError(f"parallel {label}: an update past its bounds ({worst[0]:.4f}, {worst[1]})")
    return worst[0]


def par_stats_check(label: str, got: dict, want: dict, init: dict, gap: float, dtype: str) -> float:
    """The BN running averages of ``got`` against ``want``: each within
    3x ``gap`` (two one-process runs' largest running-average difference)
    or PAR_STAT_FLOOR[dtype] of how far the steps moved it, whichever is
    larger. Logs the worst and returns its ratio to its limit."""
    worst = (0.0, "")
    for k, v in want.items():
        if not k.startswith("buffer:"):
            continue
        moved = float((v - init[k]).abs().max())
        limit = max(3 * gap, PAR_STAT_FLOOR[dtype] * moved)
        err = float((got[k] - v).abs().max())
        worst = max(worst, (err / limit if limit else 0.0 if err == 0 else float("inf"), k))
    log(f"parallel {label}: running averages at {worst[0]:.4f} of their limits at worst ({worst[1]})")
    if worst[0] > 1:
        raise AssertionError(f"parallel {label}: running average {worst[1]} past its limit ({worst[0]:.4f})")
    return worst[0]


def par_launch_check(label: str, launches: dict, extra: dict) -> None:
    want = dict(PAR_PER_STEP, **extra)
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"parallel {label}: {launches[k]} {k} launches a rank a step, expected {v}")


# The embedding and reconstruction tasks on ranks: each case's task, its configuration and its global batch in
# one-second clips: the embedding step at the JAX bench's 32 clips; the reconstructions at the CLI's 32; the video
# VAE at 20, the largest even batch that two ranks hold on the card by phase 14's reading (3.9 GiB of masters,
# grads and Adam slots and 0.247 GiB a frame a process: 2 x 3.9 + 240 x 0.247 = 67 GiB of 80; 22 clips 73 GiB
# before the two CUDA contexts and DDP's buckets). One fixed batch a case, PAR_STEPS steps.
PAR_TASKS = {
    "embed": ("embed", {}, 32),
    "Ac": ("reconstruct", dict(encoder_type="Ac"), 32),
    "Energy": ("reconstruct", dict(encoder_type="Energy"), 32),
    "Audio": ("reconstruct", dict(encoder_type="Audio"), 32),
    "Video": ("reconstruct", dict(encoder_type="Video"), 20),
}
PAR_TASK_F32 = {"embed": 4, "Ac": 4}  # the f32 cases and their global clips
# Two ranks against one process, after step 1 (the same weights, the split batch):
# - the loss, relative: f32 at the generation cases' PAR_LOSS_REL; bf16 at the CPU tests' 1e-4, since each rank's
#   convolutions run at half the batch, whose bf16 roundings differ (the embedding step read 7.9e-5 in five runs);
# - each of its terms: f32 at the CPU tests' 1e-4 (the KL and reconstruction terms pass through the train-mode BNs'
#   fast-variance cancellation), bf16 at 1e-3;
# - the gradient, read as Adam's first moment (TF1's: 0.1 of it), in L2 over each VAE's leaves, the conv biases
#   that a train-mode BN follows left out (their true gradient is zero): f32 5e-2 over a VAE with a train-mode BN
#   (tests/test_torch_parallel_embed.py's) and 1e-2 over one without; bf16 0.25 and 5e-2. A gradient N times too
#   large or too small reads |1 - N| or |1 - 1/N| there. Read on an H100 80GB HBM3 at 700 W: f32 the acoustic VAE
#   4.3e-7, the audio and video VAEs 1.7e-2 and 1.2e-2, Ac 9.9e-4; bf16 the video VAE 0.19, the embedding's audio
#   and video VAEs 0.13 and 0.092, its acoustic VAE 8.5e-3, Ac 1.3e-3;
# - the BN running averages within PAR_STAT_FLOOR of how far step 1 moved them;
# - in f32 the updates at all three trajectory bounds, but the BN VAEs' at the first alone (``bn_leaves``).
PAR_TASK_LOSS_REL = {"float32": PAR_LOSS_REL, "bfloat16": 1e-4}
PAR_TASK_TERM_REL = {"float32": 1e-4, "bfloat16": 1e-3}
PAR_TASK_GRAD_TOL = {"float32": dict(bn=5e-2, plain=1e-2), "bfloat16": dict(bn=0.25, plain=5e-2)}
# Then steps 2-3, whose weights differ by the +-lr steps Adam takes on gradients at rounding level: every update
# entry within 2 lr a step (``adam_slack``), f32 ``Ac`` at all three trajectory bounds, and the losses within these
# shares of one process's, each at least 2x the largest read on an H100 80GB HBM3 at 700 W over six runs (bf16:
# embed 2.98e-3, Video 1.22e-3, Audio 5.8e-6, Ac and Energy 4.4e-7; f32: embed 6.2e-2, Ac 1.2e-7). The f32
# embedding step's loss jumps at step 3 (51.1 to 67-71) as the batch-hard mining passes the rounding-level gaps on:
# two more one-process runs (the same run again, and from weights one f32 rounding away) show how far that alone
# moves it (read 1.2e-3-4.9e-2 and 3.2e-3-2.8e-2 in four runs, the ranks 3.9e-3-6.2e-2 in the same four).
PAR_TASK_LATER_REL = {"embed": 1e-2, "embed f32": 0.15, "Video": 5e-3, "Audio": 1e-4, "Ac": 1e-5, "Ac f32": 1e-5,
                      "Energy": 1e-5}
PAR_F32_HELD = ("Ac",)


def adam_step_bound(step: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The largest update TF1's Adam can make at ``step`` (1, 2, ...), in lr:
    its bias-corrected rate times the largest ``m / sqrt(v)`` that any
    gradients give (Cauchy-Schwarz over the steps' weights). 1 at step 1,
    1.0013 at step 2, 1.0036 at step 3."""
    w = [(1 - b1) * b1 ** (step - i) for i in range(1, step + 1)]
    u = [(1 - b2) * b2 ** (step - i) for i in range(1, step + 1)]
    rate = math.sqrt(1 - b2**step) / (1 - b1**step)
    return rate * math.sqrt(sum(x * x / y for x, y in zip(w, u)))


def adam_slack(steps: int):
    """How far apart two runs' updates may lie after ``steps`` steps, entry
    by entry, as a function of the initial tensor: twice the largest update
    TF1's Adam can make at each step (an entry whose gradient's sign differs
    at every step reaches it) plus the f32 rounding of each step and of the
    parameter."""
    eps = torch.finfo(torch.float32).eps
    top = 2 * PAR_LR * (1 + 4 * eps) * sum(adam_step_bound(t) for t in range(1, steps + 1))
    return lambda init: top + 2 * steps * eps * init.abs()


def bn_cancelled(names) -> set:
    """The conv biases that a train-mode BN follows (their true gradient is
    zero): ``<layer>.conv_<i>.bias`` beside ``<layer>.bn_<i>``,
    ``<layer>.pool_<i>.bias`` beside ``<layer>.bn_pool_<i>``."""
    out = set()
    for n in names:
        m = re.fullmatch(r"(.*)\.(conv|pool)_(\d+)\.bias", n)
        if m and f"{m[1]}.bn_{'pool_' if m[2] == 'pool' else ''}{m[3]}.weight" in names:
            out.add(n)
    return out


def bn_leaves(tensors: dict) -> set:
    """The trained tensors of the VAEs (first name component) that hold a
    train-mode BN: their entries whose gradients sit at rounding level take
    +-lr steps of either sign, so they are held to the first trajectory bound
    alone, as tests/test_torch_parallel_embed.py holds the audio and video
    VAEs; their gradient is held in L2 (``par_grad_check``)."""
    names = [k for k in tensors if ":" not in k]
    with_bn = {n.split(".")[0] for n in names if ".bn_" in n}
    return {n for n in names if n.split(".")[0] in with_bn}


def par_grad_check(label: str, got: dict, want: dict, dtype: str) -> float:
    """Step 1's gradient (the ``mu:`` moments) of ``got`` against
    ``want``'s in L2 over each VAE's leaves (the first name component), the
    BN-cancelled biases left out, at PAR_TASK_GRAD_TOL; logs each VAE's
    gap and its worst leaf, returns the worst share of a limit."""
    names = {k[3:] for k in want if k.startswith("mu:")}
    skip = bn_cancelled(names)
    sums, leaf = {}, {}
    for n in sorted(names - skip):
        g, w = got["mu:" + n].double(), want["mu:" + n].double()
        num, den = float((g - w).norm()) ** 2, float(w.norm()) ** 2
        s = sums.setdefault(n.split(".")[0], [0.0, 0.0])
        s[0], s[1] = s[0] + num, s[1] + den
        leaf[n] = (num / den) ** 0.5 if den else 0.0 if num == 0 else float("inf")
    worst, parts = 0.0, []
    for model, (num, den) in sums.items():
        kind = "bn" if any(n.startswith(model + ".") and ".bn_" in n for n in names) else "plain"
        gap = (num / den) ** 0.5
        worst = max(worst, gap / PAR_TASK_GRAD_TOL[dtype][kind])
        top = max((v, n) for n, v in leaf.items() if n.startswith(model + "."))
        parts.append(f"{model} {gap:.3e} (limit {PAR_TASK_GRAD_TOL[dtype][kind]}; worst leaf {top[0]:.3e} {top[1]})")
    log(f"parallel {label}: step 1's gradient in L2, {len(skip)} BN-cancelled biases left out: " + ", ".join(parts))
    if worst > 1:
        raise AssertionError(f"parallel {label}: step 1's gradient past its limit ({worst:.3f})")
    return worst


def par_loss_check(label: str, got: list, want: list, name: str, dtype: str) -> float:
    """Each step's loss terms against one process's: step 1 at
    PAR_TASK_LOSS_REL, the later steps' losses at PAR_TASK_LATER_REL; logs
    each step's worst term, returns the worst share of a limit."""
    rel = lambda g, w, k: abs(g[k] - w[k]) / abs(w[k]) if w[k] else abs(g[k])
    later = PAR_TASK_LATER_REL[name if dtype == "bfloat16" else f"{name} f32"]
    total = rel(got[0], want[0], "loss")
    term = max((rel(got[0], want[0], k), k) for k in want[0] if k != "loss")
    worst = max(total / PAR_TASK_LOSS_REL[dtype], term[0] / PAR_TASK_TERM_REL[dtype])
    parts = [f"step 1 {total:.3e} (limit {PAR_TASK_LOSS_REL[dtype]}), its worst term {term[0]:.3e} ({term[1]}; "
             f"limit {PAR_TASK_TERM_REL[dtype]})"]
    for step, (g, w) in enumerate(zip(got[1:], want[1:]), 2):
        worst = max(worst, rel(g, w, "loss") / later)
        parts.append(f"step {step} {rel(g, w, 'loss'):.3e} (limit {later})")
    log(f"parallel {label}: losses against one process, relative: " + ", ".join(parts))
    if worst > 1:
        raise AssertionError(f"parallel {label}: a loss past its limit ({worst:.3f})")
    return worst


def par_task_trainer(name: str, dtype: str, fsdp: bool = False, nudge: bool = False):
    """The case's trainer from the seed's weights; ``nudge`` moves each
    weight by one f32 rounding of either sign."""
    from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, ParallelConfig
    from acoustic_image_generation_tpu_torch.parallel import mesh
    from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    family, config, _ = PAR_TASKS[name]
    device = mesh.device() or "cuda"
    if family == "embed":
        task = EmbedTask(EmbedConfig(compute_dtype=dtype, seed=SEED), device=device).init_params(SEED)
    else:
        task = family_task(family, config, device, dtype)
    if nudge:
        gen = torch.Generator().manual_seed(SEED + 600)
        with torch.no_grad():
            for p in task.parameters():
                sign = 2.0 * torch.randint(0, 2, p.shape, generator=gen) - 1
                p.mul_(1 + torch.finfo(torch.float32).eps * sign.to(p.device, p.dtype))
    return Trainer(task, ExperimentConfig(parallel=ParallelConfig(compute_dtype=dtype, fsdp=fsdp,
                                                                  num_devices=mesh.world())))


@functools.cache
def par_task_batch(name: str, clips: int) -> dict:
    """The case's global batch; a (clips, 12, 1, 1, 3) placeholder for the
    video of a task that does not read it. Quiet audio (samples in {-1, 0},
    as phase 14's spectrogram reconstruction) where a loss holds the MSE
    against raw magnitudes: from int16-range samples that term is about
    3e10 (read 3.07e10 on the embedding step), and its train-mode BNs'
    roundings reach every audio gradient."""
    rng = np.random.default_rng(SEED + 500)
    f = (clips, 12)
    quiet = name in ("embed", "Audio")
    raw = dict(acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
               audio=rng.integers(-1 if quiet else -(2**15), 1 if quiet else 2**15, (*f, 1024), dtype=np.int32),
               action=(np.arange(clips) % 4).astype(np.int32), location=np.zeros(clips, np.int32))
    reads_video = name in ("embed", "Video")
    raw["video"] = (rng.integers(0, 256, (*f, 224, 298, 3), dtype=np.uint8) if reads_video
                    else np.zeros((*f, 1, 1, 3), np.uint8))
    return raw


def par_task_steps(name: str, dtype: str = "bfloat16", fsdp: bool = False, label: str = "",
                   keep_init: bool = False, nudge: bool = False, first: bool = True) -> dict:
    """``par_run`` of a task case: PAR_STEPS steps on this rank's rows of
    its global batch, with ``first`` what the first step left (in f32 with
    the parameters)."""
    from acoustic_image_generation_tpu_torch.parallel import mesh

    clips = PAR_TASKS[name][2] if dtype == "bfloat16" else PAR_TASK_F32[name]
    raw = {k: mesh.shard_rows(v) for k, v in par_task_batch(name, clips).items()}
    trainer = par_task_trainer(name, dtype, fsdp, nudge)
    out = par_run(trainer, [raw] * PAR_STEPS, label and f"{label}, {clips} clips", first=first,
                  first_params=dtype == "float32", keep_init=keep_init)
    del trainer
    torch.cuda.empty_cache()
    return out


def par_task_n1() -> dict:
    """Rank 0 of one over NCCL: each task case through the DDP-wrapped
    trainer."""
    return {name: par_task_steps(name, label=f"N=1 NCCL {name}", first=False) for name in PAR_TASKS}


def par_task_ranks() -> dict:
    """One of two ranks on one card over gloo: each task case under DDP and
    FSDP at bf16, and the f32 cases under both."""
    from acoustic_image_generation_tpu_torch.parallel import mesh

    out = {}
    for name in PAR_TASKS:
        for fsdp in (False, True):
            case = f"{name} {'fsdp' if fsdp else 'ddp'}"
            out[case] = par_task_steps(name, fsdp=fsdp, label=f"rank {mesh.rank()} {case} (gloo, host-staged)")
    for name in PAR_TASK_F32:
        for fsdp in (False, True):
            case = f"{name} f32 {'fsdp' if fsdp else 'ddp'}"
            out[case] = par_task_steps(name, "float32", fsdp, label=f"rank {mesh.rank()} {case} (gloo, host-staged)")
    return out


def par_task_phase(plain: dict, init: dict, n1: dict, ranks: list) -> None:
    """The task cases' checks: one rank over NCCL against the plain trainer
    (step 1's loss to the bit, the launches a step); two ranks against each
    other (bit for bit) and against one process: after step 1 the loss
    terms, the gradient, the running averages and (f32) the updates at the
    three trajectory bounds; the later steps' losses and updates; the
    launches a step, each rank's peak memory. Every check runs and logs
    before the first failure is raised."""
    t0, failed = time.perf_counter(), []
    for name in PAR_TASKS:
        got, want = n1[name], plain[name]
        if got["losses"][0] != want["losses"][0] or got["launches"] != want["launches"]:
            failed.append(f"parallel N=1 {name}: step 1's loss {got['losses'][0]} and launches {got['launches']}, "
                          f"one process {want['losses'][0]} and {want['launches']}")
            continue
        log(f"parallel N=1 over NCCL {name} ({card()}): step 1's loss equal to the plain trainer's, "
            f"{got['losses']} against {want['losses']}; step median {statistics.median(got['times'][1:]):.1f} ms "
            f"against the plain trainer's {statistics.median(want['times'][1:]):.1f} ms")
    for extra in ("again", "nudged"):
        a, b = plain[f"embed f32 {extra}"]["losses"], plain["embed f32"]["losses"]
        log(f"parallel one process embed f32 {extra} ({card()}): losses {a} against {b}, relative "
            f"{[f'{abs(x - y) / abs(y):.3e}' for x, y in zip(a, b)]}")
    r0, r1 = ranks
    for case in r0:
        name, f32 = case.split()[0], " f32 " in case
        key, dtype = (f"{name} f32", "float32") if f32 else (name, "bfloat16")
        ref, got = plain[key], r0[case]
        clips = PAR_TASK_F32[name] if f32 else PAR_TASKS[name][2]
        if got["digest"] != r1[case]["digest"] or got["losses"] != r1[case]["losses"]:
            failed.append(f"parallel {case}: the two ranks hold different states or losses")
        if not got["launches"] == ref["launches"] == r1[case]["launches"]:
            failed.append(f"parallel {case}: launches a rank a step {got['launches']}, {r1[case]['launches']}; "
                          f"one process {ref['launches']}")
        # JAX's fsdp_sharding keeps every tensor of fewer than 2^18 entries whole: all of UNetEnergy's
        if case.endswith("fsdp") and ((got["sharded"] > 0) != (got["moments"] < 0.75 * ref["moments"])
                                      or not (got["sharded"] or name == "Energy")):
            failed.append(f"parallel {case}: {got['sharded']} tensors sharded, Adam moments {got['moments']} bytes "
                          f"against one process's {ref['moments']}")
        first, first_ref = got["first"], ref["first"]
        held(failed, par_loss_check, case, got["metrics"], ref["metrics"], name, dtype)
        held(failed, par_grad_check, case, first, first_ref, dtype)
        held(failed, par_stats_check, f"{case} after step 1", first, first_ref, init[key], 0.0, dtype)
        if f32:
            held(failed, par_update_check, f"{case} after step 1", first, first_ref, init[key], 3, adam_slack(1),
                 bn_leaves(first_ref))
        held(failed, par_update_check, f"{case} after {PAR_STEPS} steps", got["tensors"], ref["tensors"], init[key],
             3 if f32 and name in PAR_F32_HELD else 1, adam_slack(PAR_STEPS))
        held([], par_stats_check, f"{case} after {PAR_STEPS} steps (logged, not held)", got["tensors"],
             ref["tensors"], init[key], 0.0, dtype)
        log(f"parallel 2 ranks {case} against one process ({card()}): {clips} clips, step median "
            f"{statistics.median(got['times'][1:]):.1f} ms (gloo, host-staged) against one process's "
            f"{statistics.median(ref['times'][1:]):.1f} ms; Adam moments {got['moments'] / 2**20:.1f} MiB a rank "
            f"(one process {ref['moments'] / 2**20:.1f} MiB), {got['sharded']} tensors sharded; peak "
            f"{got['peak']:.2f} and {r1[case]['peak']:.2f} GiB on the two ranks (one process {ref['peak']:.2f} GiB)")
    log(f"parallel: the task cases' checks took {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))


def held(failed: list, check, *args):
    """``check(*args)``; an AssertionError it raises goes into ``failed``."""
    try:
        check(*args)
    except AssertionError as e:
        failed.append(str(e))


def par_n1(seed: int) -> dict:
    """Rank 0 of one over NCCL: the train-BN (``fused_bn_stats``) and frozen
    cases through the DDP-wrapped trainer."""
    batches = par_batches(seed)
    out = {case: par_steps(seed, case, batches, label=f"N=1 NCCL {case}") for case in ("train_bn", "frozen")}
    del batches
    out["tasks"] = par_task_n1()
    return out


def par_ranks(seed: int, lists: dict) -> dict:
    """One of two ranks on one card over gloo: DDP (train-BN with
    ``fused_bn_stats``, int8), FSDP (train-BN), DDP and FSDP in f32 on the
    same batches, then the cached path from the shards (3
    epochs, host-sharded loader) after the uncached frozen steps on the same
    first batches."""
    from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
    from acoustic_image_generation_tpu_torch.parallel import mesh

    batches = par_batches(seed)
    out = {"ddp": par_steps(seed, "train_bn", batches, label=f"rank {mesh.rank()} DDP train_bn (gloo, host-staged)"),
           "int8": par_steps(seed, "int8", batches, label=f"rank {mesh.rank()} DDP int8 (gloo, host-staged)"),
           "fsdp": par_steps(seed, "train_bn", batches, fsdp=True,
                             label=f"rank {mesh.rank()} FSDP train_bn (gloo, host-staged)")}
    out["f32 ddp"] = par_steps(seed, "f32", batches, label=f"rank {mesh.rank()} DDP f32 (gloo, host-staged)")
    out["f32 fsdp"] = par_steps(seed, "f32", batches, fsdp=True,
                                label=f"rank {mesh.rank()} FSDP f32 (gloo, host-staged)")
    loader = AcousticImageDataLoader(lists["training"], "training", PAR_CLIPS, shard_index=mesh.rank(),
                                     shard_count=mesh.world(), use_native=True, seed=seed)
    first = [dict(acoustic=b.acoustic, audio=b.audio, video=b.video) for b in loader.batches(0)]
    out["uncached"] = par_steps(seed, "frozen", first, label=f"rank {mesh.rank()} uncached frozen (gloo)")
    trainer = par_trainer(seed, "cached")
    state = trainer.init_state()
    counters = par_counters()
    for fn in counters.values():
        fn.launches = 0
    losses, runs, times, tiers = [], [], [], []
    for epoch in range(CACHE_EPOCHS):
        before = trainer.trunk_runs
        for raw in loader.batches(epoch):
            t0 = time.perf_counter()
            state, metrics = trainer.train_step(state, raw)
            losses.append(float(metrics["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            tiers.append(trainer.last_tier)
        runs.append(trainer.trunk_runs - before)
    out["cached"] = dict(losses=losses, trunk_runs=runs, times=times, tiers=tiers,
                         total={k: fn.launches for k, fn in counters.items()},
                         launches={k: fn.launches / len(losses) for k, fn in counters.items()})
    log(f"parallel rank {mesh.rank()} cached (gloo): {CACHE_EPOCHS} epochs, trunk runs {runs}, tiers {tiers}, "
        f"losses {[f'{v:.6g}' for v in losses]}, step ms {[round(t, 1) for t in times]}")
    del trainer, state, batches, first
    torch.cuda.empty_cache()
    out["tasks"] = par_task_ranks()
    return out


def par_nccl(seed: int) -> dict:
    """Rank r of N >= 2 cards over NCCL: DDP and FSDP train-BN steps."""
    batches = par_batches(seed)
    return {"ddp": par_steps(seed, "train_bn", batches, label="NCCL DDP train_bn"),
            "fsdp": par_steps(seed, "train_bn", batches, fsdp=True, label="NCCL FSDP train_bn")}


def parallel_phase(lists: dict, root: Path) -> dict:
    """Phase 16: the generation task on ranks (``parallel/mesh.py``), at full
    width, bf16, random weights and noise from the seed, 64-clip global
    batches, then the embedding and reconstruction tasks (``PAR_TASKS``),
    each rank's launches reset just before its steps and read just after.
    Returns rank 0's launches over the phase."""
    from acoustic_image_generation_tpu_torch.parallel import mesh

    from acoustic_image_generation_tpu_torch.data import native

    if not native.available():  # built here, before the ranks' loaders need it
        raise AssertionError(f"the native decoder does not build: {native.build_error()}")
    batches = par_batches(SEED)
    plain = {}
    for case, runs in (("train_bn", 2), ("frozen", 1), ("int8", 1), ("f32", 1)):
        plain[case] = [par_steps(SEED, case, batches, label=f"one process {case} run {i + 1}") for i in range(runs)]
    del batches
    def weights(case):
        task = par_trainer(SEED, case).task
        return {**{n: p.detach().float().cpu() for n, p in task.named_parameters() if p.requires_grad},
                **{"buffer:" + n: b.detach().cpu().clone() for n, b in task.named_buffers()}}

    init, f32_init = weights("train_bn"), weights("f32")
    torch.cuda.empty_cache()
    # the embedding and reconstruction tasks: one process, and the weights every run starts from
    task_plain, task_init = {}, {}
    for name in PAR_TASKS:
        task_plain[name] = par_task_steps(name, label=f"one process {name}", keep_init=True)
        task_init[name] = task_plain[name].pop("init")
    for name in PAR_TASK_F32:
        task_plain[f"{name} f32"] = par_task_steps(name, "float32", label=f"one process {name} f32")
        task_init[f"{name} f32"] = task_init[name]  # the f32 masters of either compute dtype
    # how far the f32 embedding step's later losses move without ranks: the same run again, and from weights one
    # f32 rounding away
    task_plain["embed f32 again"] = par_task_steps("embed", "float32", label="one process embed f32 again")
    task_plain["embed f32 nudged"] = par_task_steps("embed", "float32", label="one process embed f32 nudged",
                                                    nudge=True)
    a, b = (r["tensors"] for r in plain["train_bn"])
    gap_w = par_gap(a, b)
    gap_s = max(float((a[k] - b[k]).abs().max()) for k in a if k.startswith("buffer:"))
    log(f"parallel: two one-process train_bn runs differ by {gap_w:.3e} in the trained tensors (conv_chain's "
        f"dW atomics) and {gap_s:.3e} in the running averages")

    n1 = mesh.launch(par_n1, 1, SEED, device="cuda")[0]
    for case in ("train_bn", "frozen"):
        got, want = n1[case], plain[case][0]
        par_launch_check(f"N=1 {case}", got["launches"], {"matmul_stats": 36 if case == "train_bn" else 0})
        if got["losses"][0] != want["losses"][0]:
            raise AssertionError(f"parallel N=1 {case}: step 1's loss {got['losses'][0]} is not the one-process "
                                 f"{want['losses'][0]}")
        err = par_gap(got["tensors"], want["tensors"])
        share = par_update_check(f"N=1 {case}", got["tensors"], want["tensors"], init)
        ratio = par_stats_check(f"N=1 {case}", got["tensors"], want["tensors"], init, gap_s, "bfloat16")
        log(f"parallel N=1 over NCCL {case} ({card()}): losses equal at step 1, {got['losses']} against "
            f"{want['losses']}; weights {err:.3e} from the one-process run ({err / gap_w if gap_w else 0:.1f}x "
            f"the one-process spread), updates at {share:.2f} of their limits, running averages at {ratio:.2f} of "
            f"their limit; step median {statistics.median(got['times'][1:]):.1f} ms against the plain trainer's "
            f"{statistics.median(want['times'][1:]):.1f} ms (DDP's hooks, NCCL of one)")

    ranks = mesh.launch(par_ranks, 2, SEED, lists, device="cuda:0")
    r0, r1 = ranks
    for case, ref, extra in (("ddp", plain["train_bn"][0], {"matmul_stats": 36}),
                             ("int8", plain["int8"][0], {"qgemm_s8": 36}),
                             ("fsdp", r0["ddp"], {"matmul_stats": 36}),
                             ("f32 ddp", plain["f32"][0], None), ("f32 fsdp", plain["f32"][0], None)):
        got = r0[case]
        if got["digest"] != r1[case]["digest"] or got["losses"] != r1[case]["losses"]:
            raise AssertionError(f"parallel {case}: the two ranks hold different states or losses")
        if extra is not None:  # the f32 backward keeps a gate launch a layer
            par_launch_check(case, got["launches"], extra)
        err = par_gap(got["tensors"], ref["tensors"])
        share = par_update_check(case, got["tensors"], ref["tensors"], init if extra is not None else f32_init,
                                 held=1 if extra is not None else 3)
        f32 = extra is None
        ratio = par_stats_check(case, got["tensors"], ref["tensors"], f32_init if f32 else init, gap_s,
                                "float32" if f32 else "bfloat16")
        rel = max(abs(x - y) / abs(y) for x, y in zip(got["losses"], ref["losses"]))
        mse = max(abs(x["mse"] - y["mse"]) / abs(y["mse"]) for x, y in zip(got["metrics"], ref["metrics"]))
        if rel > PAR_LOSS_REL:
            raise AssertionError(f"parallel {case}: losses {got['losses']} against {ref['losses']} ({rel:.2e})")
        log(f"parallel 2 ranks {case} against {'DDP' if case == 'fsdp' else 'one process'} ({card()}): weights "
            f"{err:.3e} apart ({err / gap_w if gap_w else float('inf'):.1f}x the one-process spread), updates at "
            f"{share:.2f} of their limits, running averages at {ratio:.2f} of theirs, losses {rel:.2e} and mse "
            f"{mse:.2e} relative; step median {statistics.median(got['times'][1:]):.1f} ms (gloo, host-staged); Adam "
            f"moments {got['moments'] / 2**20:.1f} MiB a rank (one process "
            f"{plain['train_bn'][0]['moments'] / 2**20:.1f} MiB); peak {got['peak']:.2f} GiB a rank")
    if not np.array_equal(r0["int8"]["amax"], plain["int8"][0]["amax"]) or \
            not np.array_equal(r1["int8"]["amax"], plain["int8"][0]["amax"]):
        raise AssertionError("parallel int8: the ranks' amaxes differ from the one-process calibration")
    log(f"parallel int8: both ranks' {len(plain['int8'][0]['amax'])} amaxes equal the one-process calibration")
    if not r0["fsdp"]["moments"] < 0.75 * r0["ddp"]["moments"]:
        raise AssertionError("parallel fsdp: the Adam moments are not sharded")
    for r, out in enumerate(ranks):
        cached, uncached = out["cached"], out["uncached"]
        par_launch_check(f"rank {r} cached", cached["launches"], {})
        first = cached["losses"][:len(uncached["losses"])]
        rel = max(abs(x - y) / abs(y) for x, y in zip(first, uncached["losses"]))
        if rel > PAR_LOSS_TOL or cached["trunk_runs"][0] != len(uncached["losses"]):
            raise AssertionError(f"parallel rank {r} cached: fill losses {first} against uncached "
                                 f"{uncached['losses']} ({rel:.2e}), trunk runs {cached['trunk_runs']}")
        later = cached["tiers"][len(uncached["losses"]):]
        if "fill" in later:
            raise AssertionError(f"parallel rank {r} cached: tiers {cached['tiers']}: a later epoch ran the trunk "
                                 "on a whole batch")
        by_tier = {t: statistics.median([ms for ms, u in zip(cached["times"], cached["tiers"]) if u == t])
                   for t in sorted(set(cached["tiers"]))}
        log(f"parallel rank {r} cached against uncached on the same rows ({card()}): {rel:.2e} relative; trunk "
            f"runs an epoch {cached['trunk_runs']}, tiers {cached['tiers']} (the partial tier runs the trunk on "
            f"the windows that moved here from the other rank); median step ms by tier "
            f"{ {t: round(v, 1) for t, v in by_tier.items()} }, uncached {statistics.median(uncached['times']):.1f}")
    par_task_phase(task_plain, task_init, n1["tasks"], [r["tasks"] for r in ranks])
    if torch.cuda.device_count() >= 2:
        n = min(4, torch.cuda.device_count())
        nccl = mesh.launch(par_nccl, n, SEED, device="cuda")
        for case in ("ddp", "fsdp"):
            err = par_gap(nccl[0][case]["tensors"], plain["train_bn"][0]["tensors"])
            par_update_check(f"NCCL {n} GPUs {case}", nccl[0][case]["tensors"], plain["train_bn"][0]["tensors"], init)
            if len({o[case]["digest"] for o in nccl}) != 1:
                raise AssertionError(f"parallel NCCL {n} GPUs {case}: the ranks hold different states")
            log(f"parallel {n} GPUs over NCCL {case} ({card()}): weights {err:.3e} from one process, step median "
                f"{statistics.median(nccl[0][case]['times'][1:]):.1f} ms")
        from acoustic_image_generation_tpu_torch.cli import main as pmain

        flags = workflow_flags(lists, root, "parallel", "--num_epochs", "1", "--num_devices", str(n))
        if pmain.main(["--mode", "train", *flags]) != 0:
            raise AssertionError("parallel CLI --num_devices: train failed")
        from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker

        run = root / "runs" / "parallel"
        best = run / f"epoch_{BestTracker.read_best_epoch(str(run))}.ckpt"
        if pmain.main(["--mode", "test", *flags, "--restore_checkpoint", str(best)]) != 0:
            raise AssertionError("parallel CLI --num_devices: test failed")
        log(f"parallel CLI --num_devices {n}: train and test over NCCL")
    else:
        log(f"parallel: this machine has {torch.cuda.device_count()} CUDA device; DDP and FSDP over NCCL on more "
            "than one card are not run")
    launches = {k: 0 for k in par_counters()}  # rank 0's, over the phase's ranks
    for out in (n1["train_bn"], n1["frozen"], *(r0[c] for c in PAR_RANK_CASES), r0["cached"],
                *n1["tasks"].values(), *r0["tasks"].values()):
        for k, v in out["total"].items():
            launches[k] += v
    return launches


# ---------------------------------------------------------------- phase 17
# Raw captures through the port's converters (data/convert.py, cli/tools.py), the TUT loader (data/tut.py)
# and profiling on torch.profiler (utils/profiling.py)

CONVERT_RAW = dict(classes=2, captures=2, seconds=3)  # class_X/data_YYY captures, each 3 s of 12288 Hz audio
CONVERT_CLIPS = 3  # --batch_size: the training list's 2 captures x 3 s are 2 steps, validation's 3 s one batch
CONVERT_STEPS = 5  # in-process steps after the command line's epoch, timed by StepTimer after the first
CONVERT_TRACED = 2  # then steps under profiling.trace
TUT_RECORDS = 4  # 10 s records at 22050 Hz


def write_raw(raw: Path, pil: bool) -> dict:
    """The raw layouts the five converters read, written with numpy and
    scipy: 128-mic ``.dc`` files and ``class_X/data_YYY`` captures (a 12288
    Hz ``audio/output_audio2.wav`` of a class tone in noise,
    ``video_time.txt``), and with Pillow the captures' BMP frames and small
    FlickrSoundNet, AVE and collected layouts. Returns {name: directory}."""
    import shutil
    import xml.etree.ElementTree as ET

    from scipy.io import wavfile

    rng = np.random.default_rng(SEED + 170)
    rate, secs = 12288, CONVERT_RAW["seconds"]
    frame = lambda h, w: rng.integers(0, 255, (h, w, 3), np.uint8)
    for c in range(CONVERT_RAW["classes"]):
        for d in range(CONVERT_RAW["captures"]):
            cap = raw / "captures" / f"class_{c}" / f"data_{d:03d}"
            (cap / "audio").mkdir(parents=True)
            (cap / "video").mkdir()
            t = np.arange(secs * rate)
            wav = 6000 * np.sin(2 * np.pi * (220 + 440 * c) * t / rate) + rng.normal(0, 800, t.size)
            wavfile.write(cap / "audio" / "output_audio2.wav", rate, wav.astype(np.int16))
            (cap / "video_time.txt").write_text(f"video seconds: {secs}")
            if pil:
                from PIL import Image

                for i in range(12 * secs):
                    Image.fromarray(frame(240, 320)).save(cap / "video" / f"I_{i + 1:06d}.bmp")
    dc = raw / "dc" / "audio"
    dc.mkdir(parents=True)
    for h in range(3):
        rng.integers(-(2**20), 2**20, (128, 1024)).astype(np.int32).flatten(order="F").tofile(dc / f"A_{h + 1:06d}.dc")

    dirs = {"captures": raw / "captures", "dc": raw / "dc"}
    if not pil:
        return dirs
    from PIL import Image

    def short_wav(path, fs):
        wavfile.write(path, fs, (10000 * np.sin(2 * np.pi * 440 * np.arange(int(1.5 * fs)) / fs)).astype(np.int16))

    flickr = raw / "flickr"
    data, ann = flickr / "Dataset" / "Data" / "0", flickr / "Dataset" / "Annotations"
    data.mkdir(parents=True)
    ann.mkdir(parents=True)
    for i in (3, 7):
        Image.fromarray(frame(256, 256)).save(data / f"{i}.jpg")
        short_wav(data / f"{i}.wav", 22050)
        root = ET.Element("annotation")
        ET.SubElement(root, "file_name").text = f"{i}.jpg"
        bb = ET.SubElement(ET.SubElement(root, "person"), "bbox")
        for tag, v in (("type", "object"), ("xmin", 10), ("ymin", 20), ("xmax", 120), ("ymax", 200)):
            ET.SubElement(bb, tag).text = str(v)
        ET.ElementTree(root).write(ann / f"{i}.xml")
    (flickr / "test_list.txt").write_text("3.jpg\n7.jpg\n")
    ave = raw / "ave" / "class_3" / "data_002"
    shutil.copytree(raw / "captures" / "class_0" / "data_000", ave)
    (ave / "seconds.txt").write_text("1:1\n")
    collected = raw / "collected"
    collected.mkdir()
    for i in (14, 20):
        Image.fromarray(frame(150, 200)).save(collected / f"{i}.png")
        short_wav(collected / f"{i}.wav", 22050)
    (collected / "test_list.txt").write_text("14.png\n20.png\n")
    return dict(dirs, flickr=flickr, ave=raw / "ave", collected=collected)


# the tools, one process: each command's argv, its printed lines, and whether the process loaded CUDA code
TOOLS_DRIVER = """
import json, sys
import torch
from acoustic_image_generation_tpu_torch.cli import tools
for argv in json.loads(sys.argv[1]):
    print("$ tools " + " ".join(argv), flush=True)
    if tools.main(argv) != 0:
        sys.exit(f"tools {argv[0]} failed")
ops = sorted(m for m in sys.modules if m.startswith("acoustic_image_generation_tpu_torch.ops"))
print(json.dumps({"ops_modules": ops, "cuda_initialized": torch.cuda.is_initialized()}))
"""


def run_tools(dirs: dict, out: Path, pil: bool) -> tuple[dict, dict, float]:
    """``tools convert``, ``reshard`` (every split) and, where there is the
    layout, ``convert-flickr``, ``convert-ave`` and ``convert-collected`` in
    one subprocess. Returns the lists {split: path} of ``convert``, those
    of ``reshard`` and the process's seconds."""
    mods = ["1", "2"] if pil else ["1"]
    gz = out / "gz"
    cmds = [["convert", str(dirs["captures"]), str(gz), "--modalities", *mods]]
    cmds += [["reshard", str(gz / "lists" / f"{s}.txt"), str(out / "flat")]
             for s in ("training", "validation", "testing")]
    for name in ("flickr", "ave", "collected"):
        if name in dirs:
            cmds.append([f"convert-{name}", str(dirs[name]), str(out / name), "--modalities", *mods])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TOOLS_DRIVER, json.dumps(cmds)], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the converter tools failed: {proc.stdout[-1500:]} {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"  {line[:200]}")
    tail = json.loads(lines[-1])
    if tail["ops_modules"] or tail["cuda_initialized"]:
        raise AssertionError(f"the converter process loaded CUDA code: {tail}")
    converted = json.loads(lines[lines.index("$ tools " + " ".join(cmds[1])) - 1])
    flat = {s: str(out / "flat" / f"{s}.txt") for s in ("training", "validation", "testing")}
    return converted, flat, secs


def check_converted_audio(flat: dict, raw: Path) -> int:
    """Every second's ``audio/data`` of the resharded lists, read back by
    the loader's C++ decoder, against the wav's samples: bit for bit.
    Returns the seconds checked."""
    from scipy.io import wavfile

    from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader

    checked = 0
    for split, path in flat.items():
        loader = AcousticImageDataLoader(path, "testing", 1, modalities=(1,), use_native=True, shuffle=False)
        for batch in loader.batches(0):
            shard = Path(loader.plan.windows[int(batch.window_ids[0])][0])
            second = int(shard.stem.split("_")[1]) - 1
            _, wav = wavfile.read(raw / "captures" / shard.parent.parent.name / shard.parent.name / "audio"
                                  / "output_audio2.wav")
            want = wav[second * 12288:(second + 1) * 12288].astype(np.int32).reshape(12, 1024)
            if batch.audio.shape != (1, 12, 1024) or not np.array_equal(batch.audio[0], want):
                raise AssertionError(f"{shard}: the decoded audio is not the wav's samples")
            if (batch.action[0], batch.location[0]) != (int(shard.parent.parent.name[6:]),
                                                        int(shard.parent.name[5:])):
                raise AssertionError(f"{shard}: class or location is not the capture's")
            checked += 1
    want = CONVERT_RAW["classes"] * CONVERT_RAW["captures"] * CONVERT_RAW["seconds"]
    if checked != want:
        raise AssertionError(f"read back {checked} seconds of {want}")
    return checked


def check_video_or_refusal(dirs: dict, converted: dict, pil: bool, root: Path) -> None:
    """With Pillow, a converted second's first frame against
    ``prepare_video_frame`` of its BMP, and the dataset converters' extras
    (boxes, event, classnumber) decoded; without it, the video conversion's
    ``ImportError`` naming Pillow."""
    from acoustic_image_generation_tpu_torch.data import convert, schema, tfrecord

    cap = dirs["captures"] / "class_0" / "data_000"
    if not pil:
        try:
            convert.convert_capture_dir(str(cap), str(root / "refused"), classes=0, location=0)
        except ImportError as e:
            log(f"pil: absent; the video conversion refuses: {e}")
            if "Pillow" not in str(e) or "--modalities 1" not in str(e):
                raise AssertionError(f"the refusal does not name Pillow and the audio-only flag: {e}")
            return
        raise AssertionError("video converted without Pillow")
    from PIL import Image

    log("pil: present")
    first = open(converted["training"]).readline().strip()
    rec = schema.decode_record(tfrecord.read_records(first)[0], include_acoustic=False)
    sec = int(Path(first).stem.split("_")[1]) - 1
    raw_dir = dirs["captures"] / Path(first).parent.parent.name / Path(first).parent.name
    want = convert.prepare_video_frame(np.asarray(Image.open(raw_dir / "video" / f"I_{12 * sec + 1:06d}.bmp")))
    if rec.video.shape != (12, 224, 298, 3) or not np.array_equal(rec.video[0], want):
        raise AssertionError(f"{first}: the first frame is not the BMP's prepared frame")
    seen = {}
    for name, key in (("flickr", "xmin"), ("ave", "event"), ("collected", "classnumber")):
        out = root / "out" / name
        shards = sorted(str(p) for p in out.rglob("*.tfrecord")) if name == "ave" else \
            (out / "testing.txt").read_text().split()
        seen[name] = [schema.decode_record(tfrecord.read_records(p)[0], include_acoustic=False).extras[key]
                      for p in shards]
    log(f"converted extras: flickr xmin {[int(v[0, 0]) for v in seen['flickr']]}, ave events {seen['ave']}, "
        f"collected classnumbers {seen['collected']}")
    if ([int(v[0, 0]) for v in seen["flickr"]] != [round(10 * 298 / 256)] * 2 or seen["ave"] != [0, 1, 0]
            or seen["collected"] != [1, 0]):
        raise AssertionError("the dataset converters' extras are not the raw annotations'")


def check_tut(root: Path) -> None:
    """TUT_RECORDS records through ``TUTDataLoader`` (training and
    inference batches), and the TUT-geometry spectrogram of a batch on the
    card against the CPU, within STFT_TOL of the peak; the stft kernel's
    wrapper refuses that geometry."""
    from acoustic_image_generation_tpu_torch.data import tfrecord, tut
    from acoustic_image_generation_tpu_torch.dsp.spectrogram import stft_magnitude
    from acoustic_image_generation_tpu_torch.ops import stft as st

    rng = np.random.default_rng(SEED + 171)
    (root / "tut").mkdir()
    records = [tut.encode_tut_record(rng.standard_normal(tut.MIN_LENGTH * tut.SAMPLE_RATE).astype(np.float32), i)
               for i in range(TUT_RECORDS)]
    tfrecord.write_records(str(root / "tut" / "tut.tfrecord"), records)
    shapes = {}
    for mode in ("training", "inference"):
        loader = tut.TUTDataLoader(str(root / "tut"), mode, 4, seed=SEED)
        batches = list(loader.batches(0))
        shapes[mode] = (len(batches), batches[0][0].shape)
        if len(batches) != loader.total_batches or batches[0][0].shape != (4, loader.segment):
            raise AssertionError(f"TUT {mode}: {shapes[mode]}")
    audio = torch.from_numpy(batches[0][0] * 3000)
    t0 = time.perf_counter()
    got = stft_magnitude(audio.cuda(), **tut.spectrogram_params())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = stft_magnitude(audio, **tut.spectrogram_params())
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    log(f"TUT ({card()}): batches {shapes}; spectrogram {tuple(got.shape)} on the card in {ms:.2f} ms (first "
        f"call), {err:.2e} of the peak from the CPU's (tol {STFT_TOL:.0e})")
    if got.shape != (4, 200, 257) or not err <= STFT_TOL:
        raise AssertionError("the TUT spectrogram on the card differs from the CPU's")
    try:
        st.stft(audio[:, :12288].contiguous().cuda(), **tut.spectrogram_params())
    except ValueError:
        return
    raise AssertionError("the stft kernel's wrapper took the TUT geometry")


def convert_phase(counters: dict, root: Path) -> dict:
    """Phase 17: raw captures -> shards through the port's five converter
    tools in a subprocess, the audio read back bit for bit, one epoch of
    DualCamNet on the tiled MFCC map from the command line over the
    converted training list (mfcc launches counted), the TUT loader and its
    spectrogram, then CONVERT_STEPS in-process steps timed by
    ``profiling.StepTimer``, two of them traced by ``profiling.trace`` and
    read by ``op_stats``, and ``device_memory_stats``' peak. Returns the
    launch counts of the phase's steps."""
    import importlib.util

    from acoustic_image_generation_tpu_torch.cli import main as cli
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer, as_raw
    from acoustic_image_generation_tpu_torch.utils import profiling

    pil = importlib.util.find_spec("PIL") is not None
    t0 = time.perf_counter()
    dirs = write_raw(root / "raw", pil)
    wrote = time.perf_counter() - t0
    converted, flat, tool_s = run_tools(dirs, root / "out", pil)
    t0 = time.perf_counter()
    seconds = check_converted_audio(flat, root / "raw")
    log(f"convert ({card()}): raw data written in {wrote:.2f} s; the tools' process {tool_s:.2f} s; {seconds} "
        f"seconds of audio read back by the C++ decoder in {time.perf_counter() - t0:.2f} s, bit-equal to the wavs")
    check_video_or_refusal(dirs, converted, pil, root)

    total = dict.fromkeys(counters, 0)
    flags = ["--model", "DualCamNet", "--mfcc", "1", "--mfccmap", "1", "--num_devices", "1", "--batch_size",
             str(CONVERT_CLIPS), "--num_epochs", "1", "--seed", str(SEED), "--train_file", flat["training"],
             "--valid_file", flat["validation"], "--test_file", flat["testing"], "--checkpoint_dir",
             str(root / "runs"), "--exp_name", "converted", "--device", "cuda"]
    with counted(counters, "convert: DualCamNet on the tiled MFCC map, one epoch", need=("mfcc",)) as c:
        cli.main(["--mode", "train", *flags])
    total = {k: total[k] + v for k, v in c.launches.items()}
    run_dir = root / "runs" / "converted"
    record = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[-1])
    missing = [n for n in ("configuration.txt", "model.txt", "metrics.jsonl", "epoch_0.ckpt")
               if not (run_dir / n).exists()]
    config = cli.config_from_args(cli.build_parser().parse_args(["--mode", "train", *flags]))
    valid_batches = len(list(cli.make_loader(config, "validation").batches(0)))
    log(f"convert train ({card()}): {record['steps']} steps in {record['seconds']:.3f} s, "
        f"{record['clips_per_sec']:.1f} clips/s, loss {record['train']['loss']:.6g}, valid accuracy "
        f"{record['valid']['accuracy']:.4f}; mfcc launches {c.launches['mfcc']} (steps {record['steps']} + "
        f"validation batches {valid_batches})")
    if missing or not np.isfinite(record["train"]["loss"]) or record["steps"] != 2:
        raise AssertionError(f"convert train: missing files {missing} or record {record}")
    if c.launches["mfcc"] != record["steps"] + valid_batches:
        raise AssertionError("convert train: not one mfcc launch a step and a validation batch")
    check_tut(root)

    task = cli.select_task(config, "cuda")
    trainer = Trainer(task, config)
    state = trainer.init_state()
    raws = [as_raw(b) for b in cli.make_loader(config, "training").batches(0)]
    timer = profiling.StepTimer(clips_per_step=CONVERT_CLIPS, warmup=1)
    torch.cuda.reset_peak_memory_stats()
    steps = CONVERT_STEPS + CONVERT_TRACED
    with counted(counters, f"convert: {steps} in-process steps", need=("mfcc",)) as c:
        for i in range(CONVERT_STEPS):
            state, metrics = trainer.train_step(state, raws[i % len(raws)])
            torch.cuda.synchronize()  # the timer reads the host's clock
            timer.step()
        with profiling.trace(str(root / "trace")):
            for i in range(CONVERT_TRACED):
                state, metrics = trainer.train_step(state, raws[i % len(raws)])
    total = {k: total[k] + v for k, v in c.launches.items()}
    if c.launches["mfcc"] != steps or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"convert steps: mfcc launches {c.launches['mfcc']}, loss {float(metrics['loss'])}")
    stats = profiling.op_stats(str(root / "trace"), steps=CONVERT_TRACED, top=10)
    every = profiling.op_stats(str(root / "trace"), steps=CONVERT_TRACED, top=10**6)["top_ops"]
    log(f"op_stats of {CONVERT_TRACED} traced steps ({card()}): {stats['total_ms']} ms a step on the device lane; "
        + ", ".join(f"{c['category']} {c['ms']} ms ({c['pct']}%, {c['gb_accessed']} GB, {c['gbps']} GB/s)"
                    for c in stats["by_category"]))
    for op in stats["top_ops"]:
        log(f"  {op['ms']:8.3f} ms {op['gb_accessed']:6.3f} GB  {op['op'][:100]}")
    mfcc_ops = [op for op in every if "mfcc_kernel" in op["op"]]
    if not mfcc_ops or stats["by_category"][0]["category"] not in profiling.DEVICE_CATEGORIES:
        raise AssertionError("the trace read no device lane, or no mfcc kernel in it")
    mem = profiling.device_memory_stats()
    peak = mem[0]["allocated_bytes.all.peak"]
    log(f"convert steps ({card()}): StepTimer {timer.clips_per_sec:.1f} clips/s over {timer.steps_timed} steps "
        f"({timer.seconds * 1e3:.1f} ms, a synchronize before each read); mfcc kernel {mfcc_ops[0]['ms']:.4f} ms a "
        f"step on the device; device_memory_stats: {len(mem)} device(s), peak {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    if len(mem) != torch.cuda.device_count() or peak <= 0 or not timer.clips_per_sec > 0:
        raise AssertionError("device_memory_stats or StepTimer read nothing")
    return total


def kernels_only(group: str, package_root) -> int:
    """``--trunk-gemms`` (``matmul_stats``, ``qgemm_s8``) or ``--frontends``
    (``mfcc``, ``stft``): build the group's
    kernels from the checkout at ``package_root`` (default: this one), hold
    each against its plain version and time it at its path's shapes, as the
    full run does. Prints no result line: this is a measurement, not the
    smoke run."""
    if package_root is not None:
        sys.path.insert(0, package_root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from acoustic_image_generation_tpu_torch.ops import build

    names = {"trunk_gemms": ("matmul_stats", "qgemm_s8"), "frontends": ("mfcc", "stft")}[group]
    log(f"{group} of {build.CSRC.parent}: device {torch.cuda.get_device_name(0)}, seed {SEED}")
    report = build.build(names)
    for name, (secs, text) in report.items():
        log(f"build {name}: {secs:.2f} s")
        for line in text.splitlines():
            if re.search(r"entry function|registers|spill|warning|error", line):
                log(f"  {line.strip()}")

    with torch.no_grad():
        if group == "frontends":
            from acoustic_image_generation_tpu_torch.ops import mfcc_kernel as mk
            from acoustic_image_generation_tpu_torch.ops import stft as st

            entries = [check_mfcc(mk), check_stft(st)]
        else:
            from acoustic_image_generation_tpu_torch.ops import conv_stats as cs
            from acoustic_image_generation_tpu_torch.ops import qgemm as qg

            class Task:
                dtype = torch.bfloat16

            entries = [check_matmul_stats(cs, Task), check_qgemm(qg)]
    log(json.dumps({group: entries}))
    return 0


def phase_only(which: str) -> int:
    """``--cached`` (phase 10), ``--workflow`` (phase 11), ``--classify``
    (phase 12, after the ``sosfilt`` check), ``--embed-workflow`` (phase
    13), ``--task-families`` (phase 14, with the ``conv_chain`` checks at
    UNetEnergy's chains), ``--serving`` (phase 15, its CLI part on a
    checkpoint of random weights), ``--parallel`` (phase 16) or
    ``--convert`` (phase 17, on the raw data it writes): build the kernels
    of that path and run the phase alone on its own shards. Prints no
    result line."""
    from acoustic_image_generation_tpu_torch.ops import build
    from acoustic_image_generation_tpu_torch.ops import conv_chain as cc
    from acoustic_image_generation_tpu_torch.ops import conv_stats as cs
    from acoustic_image_generation_tpu_torch.ops import mfcc_kernel as mk
    from acoustic_image_generation_tpu_torch.ops import qgemm as qg
    from acoustic_image_generation_tpu_torch.ops import sosfilt as sf
    from acoustic_image_generation_tpu_torch.ops import stft as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"{which} only: device {torch.cuda.get_device_name(0)}, seed {SEED}")
    names = {"classify": ("mfcc", "conv_chain", "sosfilt"), "embed_workflow": ("mfcc", "conv_chain", "stft"),
             "task_families": ("conv_chain", "stft"),
             "serving": ("mfcc", "conv_chain", "stft"), "convert": ("mfcc",)}.get(
                 which, ("mfcc", "conv_chain", "qgemm_s8"))
    for name, (secs, text) in build.build(names).items():
        log(f"build {name}: {secs:.2f} s")
        for fn, regs in re.findall(r"entry function '(\w+)'.*?(Used \d+ registers[^\n]*)", text, re.S):
            log(f"  {fn}: {regs}")
    counters = {"mfcc": mk.mfcc, "conv_chain": cc.conv_chain, "conv_chain_backward": cc.conv_chain_backward,
                "qgemm_s8": qg.qgemm_s8, "matmul_stats": cs.matmul_stats, "sosfilt": sf.filtfilt, "stft": st.stft}
    if which == "classify":
        log(json.dumps({"sosfilt": check_sosfilt(sf)}))
    if which == "parallel":
        build.build(("matmul_stats",))  # built here, before any rank starts
    with scratch_dir() as root:
        lists = write_shards(root) if which != "convert" else None
        t0 = time.perf_counter()
        if which == "convert":
            log(json.dumps({"convert_launches": convert_phase(counters, root)}))
        elif which == "cached":
            cached_training(counters, qg, lists, root)
        elif which == "workflow":
            workflow(counters, lists, root)
        elif which == "embed_workflow":
            embed_workflow(counters, lists, root)
        elif which == "task_families":
            task_families(counters, cc, lists, root, check_chains=True)
        elif which == "parallel":
            log(json.dumps({"parallel_launches": parallel_phase(lists, root)}))
        elif which == "serving":
            from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt

            trainer, _, _ = workflow_trainer(lists, root, "train_bn")  # a checkpoint of random weights
            path = ckpt.save_checkpoint(trainer.run_dir, 0, trainer.init_state())
            del trainer
            serving_phase(counters, lists, root, path)
        else:
            classification(counters, lists, root)
        log(f"phase {which}: {time.perf_counter() - t0:.1f} s")
    return 0


def main() -> int:
    global SEED
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=SEED, help="seed of the weights and the data")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--trunk-gemms", action="store_const", const="trunk_gemms", dest="only",
                      help="only build, check and time the trunk's GEMM kernels (matmul_stats, qgemm_s8)")
    only.add_argument("--frontends", action="store_const", const="frontends", dest="only",
                      help="only build, check and time the frontends' FFT kernels (mfcc, stft)")
    only.add_argument("--cached", action="store_const", const="cached", dest="only",
                      help="only run phase 10, cached-feature training from shards")
    only.add_argument("--workflow", action="store_const", const="workflow", dest="only",
                      help="only run phase 11, the generation workflow from the command line")
    only.add_argument("--classify", action="store_const", const="classify", dest="only",
                      help="only run phase 12, the classification family (with the sosfilt check)")
    only.add_argument("--embed-workflow", action="store_const", const="embed_workflow", dest="only",
                      help="only run phase 13, TF1 checkpoints and the embedding workflow from the command line")
    only.add_argument("--task-families", action="store_const", const="task_families", dest="only",
                      help="only run phase 14, the reconstruction, projection and joint task families")
    only.add_argument("--parallel", action="store_const", const="parallel", dest="only",
                      help="only run phase 16: the generation task on ranks (DDP, FSDP, int8, cached)")
    only.add_argument("--convert", action="store_const", const="convert", dest="only",
                      help="only run phase 17: raw captures through the converter tools, DualCamNet on the "
                           "converted shards, the TUT loader and profiling")
    only.add_argument("--serving", action="store_const", const="serving", dest="only",
                      help="only run phase 15: serving artifacts, HTTP, the artifact CLI, the box sweep, the "
                           "render step and optax's Adam")
    parser.add_argument("--package-root", default=None,
                        help="with --trunk-gemms or --frontends: import the port from this checkout "
                             "(e.g. a parent commit's)")
    args = parser.parse_args()
    SEED = args.seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.only in ("cached", "workflow", "classify", "embed_workflow", "task_families", "serving", "parallel",
                     "convert"):
        return phase_only(args.only)
    if args.only:
        return kernels_only(args.only, args.package_root)
    # IEEE f32 wherever f32 is compared: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from acoustic_image_generation_tpu_torch.ops import build
    from acoustic_image_generation_tpu_torch.ops import conv_chain as cc
    from acoustic_image_generation_tpu_torch.ops import conv_stats as cs
    from acoustic_image_generation_tpu_torch.ops import mfcc_kernel as mk
    from acoustic_image_generation_tpu_torch.ops import qgemm as qg
    from acoustic_image_generation_tpu_torch.ops import sosfilt as sf
    from acoustic_image_generation_tpu_torch.ops import stft as st
    from acoustic_image_generation_tpu_torch.serving import EmbeddingService, GenerationService
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
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
        err_fn, err_bn = check_energy_chains(cc)  # the task families' narrow chains (phase 14)
        kernels = [check_mfcc(mk), conv_chain_entry(max(err_f, err_fe, err_fn), fwd, task.dtype),
                   conv_chain_backward_entry(max(err_b, err_be, err_bn), bwd, task.dtype),
                   check_matmul_stats(cs, task), check_qgemm(qg), check_stft(st), check_sosfilt(sf)]
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
             "mfcc": mk.mfcc, "matmul_stats": cs.matmul_stats, "qgemm_s8": qg.qgemm_s8, "sosfilt": sf.filtfilt}
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
    with scratch_dir() as root:
        lists = write_shards(root)
        phase = time.perf_counter()
        cached_training(every, qg, lists, root)
        torch.cuda.empty_cache()
        log(f"phase cached training: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        flow = workflow(every, lists, root)
        torch.cuda.empty_cache()
        log(f"phase workflow: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        launches["sosfilt"] = classification(every, lists, root)["sosfilt"]
        torch.cuda.empty_cache()
        log(f"phase classification: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        embed_flow = embed_workflow(every, lists, root)
        torch.cuda.empty_cache()
        log(f"phase embed workflow: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        families = task_families(every, cc, lists, root, check_chains=False)
        torch.cuda.empty_cache()
        log(f"phase task families: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        run_dir = root / "runs" / "train_bn"
        best = run_dir / f"epoch_{BestTracker.read_best_epoch(str(run_dir))}.ckpt"
        served = serving_phase(every, lists, root, str(best))
        torch.cuda.empty_cache()
        log(f"phase serving: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        par = parallel_phase(lists, root)
        torch.cuda.empty_cache()
        log(f"phase parallel: {time.perf_counter() - phase:.1f} s")
        phase = time.perf_counter()
        conv = convert_phase(every, root)
        torch.cuda.empty_cache()
        log(f"phase convert: {time.perf_counter() - phase:.1f} s")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["workflow_launches"] = flow[k["name"]]
        k["embed_workflow_launches"] = embed_flow[k["name"]]
        k["task_families_launches"] = families[k["name"]]
        k["serving_launches"] = served[k["name"]]
        k["parallel_launches"] = par.get(k["name"], 0)
        k["convert_launches"] = conv[k["name"]]

    log(card())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # mfcc, stft: entry_times; every kernel: its launches over phase 11's, 13's, 14's, 15's, 16's and 17's passes
    extra = ("device_ms", "plain_device_ms", "library_device_ms", "host_us", "chain_ms", "clock_mhz",
             "workflow_launches", "embed_workflow_launches", "task_families_launches", "serving_launches",
             "parallel_launches", "convert_launches")
    log(json.dumps({"kernels": [{k: item[k] for k in keys + extra if k in keys or k in item}
                                for item in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
