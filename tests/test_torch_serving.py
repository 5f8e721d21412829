"""The port's serving slice against the JAX package, end to end, in f32.

Raw int32 audio and uint8 video for two frames at full video size go
through the JAX ``preprocess_batch(compute_filtered=False)`` ->
``GenerationTask._forward(train=False)`` -> ``find_logen`` and through the
port's ``GenerationService`` on the CPU, with the same weights (through
``bridge.load_flax``) and the same VAE noise (recovered from JAX's
``VaeOutput`` as ``(z - mean) / std``). The trunk has one unit per block;
the generator is at full width.

Tolerance: 1e-4 absolute on the sigmoid output (two f32 convolution stacks
that sum in different orders), 1e-3 relative on the energy map, which
exponentiates the output.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core.config import ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.dsp.energy import find_logen as jax_find_logen
from acoustic_image_generation_tpu.models.unet_ac import UNetAcResNet as JaxUNet
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcResNet
from acoustic_image_generation_tpu_torch.serving import GenerationService
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from torch_threads import few_torch_threads  # noqa: F401

UNITS = (1, 1, 1, 1)
N = 2


def _raw(seed):
    rng = np.random.default_rng(seed)
    return dict(
        audio=rng.integers(-(2**15), 2**15, (N, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (N, 224, 298, 3)).astype(np.uint8),
        acoustic=rng.random((N, 36, 48, 12)).astype(np.float32),
    )


def _jax_task(*, fused, ae):
    return JaxTask(
        ExperimentConfig(
            model=ModelConfig(resnet_units=UNITS, fused_conv=fused, ae=ae),
            parallel=ParallelConfig(compute_dtype="float32"),
        )
    )


def _jax_batch(raw):
    zeros = jnp.zeros((N,), jnp.int32)
    return jax_preprocess(
        jnp.asarray(raw["acoustic"]), jnp.asarray(raw["audio"]), jnp.asarray(raw["video"]),
        zeros, zeros, compute_filtered=False,
    )


@functools.cache
def _jax_variables(ae):
    """One init per mode: fused_conv does not change the parameter tree."""
    task = _jax_task(fused=False, ae=ae)
    return jax.jit(task.init_variables)(jax.random.key(0), _jax_batch(_raw(0)))


def _jax_run(raw, *, fused, ae):
    task = _jax_task(fused=fused, ae=ae)
    params, stats = _jax_variables(ae)
    out, _ = task._forward(params, stats, _jax_batch(raw), {"latent": jax.random.key(1)}, train=False)
    energy = jax_find_logen(out.output)
    return jax.device_get((params, stats, out, energy))


@pytest.mark.parametrize("ae", [False, True], ids=["vae", "ae"])
@pytest.mark.parametrize("fused", [False, True], ids=["xla", "fused_conv"])
def test_service_matches_jax(fused, ae):
    raw = _raw(11)
    params, stats, out, energy = _jax_run(raw, fused=fused, ae=ae)

    task = GenerationTask(
        GenerationConfig(resnet_units=UNITS, ae=ae, compute_dtype="float32"), device="cpu"
    )
    bridge.load_flax(task, params, stats)
    eps = None if ae else (out.z - out.mean) / out.std
    gen, en = GenerationService(task)(raw["audio"], raw["video"], seed=0, eps=eps)

    assert gen.shape == (N, 36, 48, 12) and gen.dtype == torch.float32
    assert en.shape == (N, 36, 48) and en.dtype == torch.float32
    np.testing.assert_allclose(gen.numpy(), out.output, rtol=0, atol=1e-4)
    np.testing.assert_allclose(en.numpy(), energy, rtol=1e-3, atol=0)


@pytest.mark.parametrize("skips", [0, 1, 2])
def test_generator_skips_match_jax(skips):
    rng = np.random.default_rng(skips)
    mfccmap = np.broadcast_to(rng.random((N, 1, 1, 12), np.float32), (N, 36, 48, 12))
    feat = rng.standard_normal((N, 12, 16, 12)).astype(np.float32)
    model = JaxUNet(skips=skips, dtype=jnp.float32)
    variables = model.init(
        {"params": jax.random.key(2), "latent": jax.random.key(3)}, jnp.asarray(mfccmap), jnp.asarray(feat)
    )
    out = jax.device_get(
        model.apply(variables, jnp.asarray(mfccmap), jnp.asarray(feat), rngs={"latent": jax.random.key(4)})
    )

    holder = torch.nn.Module()
    holder.generator = UNetAcResNet(skips=skips, device="cpu")
    bridge.load_flax(holder, {"generator": jax.device_get(variables["params"])}, {})
    eps = torch.from_numpy(np.asarray((out.z - out.mean) / out.std))
    with torch.inference_mode():
        got = holder.generator(torch.from_numpy(np.ascontiguousarray(mfccmap)), torch.from_numpy(feat), eps=eps)
    np.testing.assert_allclose(got.mean.numpy(), out.mean, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.output.numpy(), out.output, rtol=0, atol=1e-4)


def test_trunk_features_and_head_mode():
    """``trunk_features`` matches JAX's; the head mode over those features
    gives the full forward's output."""
    raw = _raw(12)
    params, stats = jax.device_get(_jax_variables(False))
    jax_task = _jax_task(fused=False, ae=False)
    batch = _jax_batch(raw)
    want = np.asarray(jax_task.trunk_features(params, stats, batch.video))

    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"), device="cpu")
    bridge.load_flax(task, params, stats)
    video = torch.from_numpy(np.array(batch.video))
    mfcc = torch.from_numpy(np.array(batch.mfcc))
    eps = torch.from_numpy(np.random.default_rng(0).standard_normal((N, 150)).astype(np.float32))
    with torch.inference_mode():
        feat = task.trunk_features(video)
        full = task._forward(mfcc, video, eps=eps).output
        head = task._forward(mfcc, video, eps=eps, trunk_feat=feat).output
    assert feat.shape == (N, 14, 19, 2048)
    np.testing.assert_allclose(feat.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(head.numpy(), full.numpy())
