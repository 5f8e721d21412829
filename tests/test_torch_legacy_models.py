"""The models no task builds, against the JAX package's, in f32 on the CPU:
``DecoderVideo``, ``DecoderEnergy``, ``DecoderAudio`` and ``MeanStd``
(``models/decoders.py``), ``VGGish`` (``models/vggish.py``) and
``UNetVideoSkip`` (``models/unet_video.py``).

Each port module gets random weights with the JAX initializers'
distributions (``init_modules``) and its biases and BN parameters drawn
away from zero; ``bridge.to_flax`` hands the same trees to the flax module,
and the outputs of both on seeded inputs are compared. ``bridge.load_flax``
of those trees into a fresh module and ``to_flax`` of it give them back to
the bit. ``UNetVideoSkip`` takes JAX's noise draw (``eps``); ``MeanStd``'s
running averages after one train step are compared too; VGGish's weights
come through ``core/tf1_import.py`` from a TF1 checkpoint's names, whose
``slim.repeat`` scopes collapse.

Tolerances: the largest error within ``TOL`` (1e-5) of the output's
largest entry (the port's other f32 model tests' bound, e.g.
``test_torch_embed.py``): both sides sum the same f32 products in another
order. ``DecoderVideo`` runs its full 224x298 convs (up to 512 channels)
at batch 1. ``UNetVideoSkip`` in train mode: 1e-3, and its running
averages within 1e-3 relative, as ``test_torch_embed_models.py`` holds the
other video VAE: each of its 18 train-mode BNs divides by flax's fast
variance E[x^2] - E[x]^2, whose cancellation magnifies a rounding gap
(read: 1.05e-5 of the largest output entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core import tf1_import as jtf1_import
from acoustic_image_generation_tpu.models import decoders as jdecoders
from acoustic_image_generation_tpu.models import unet_video as junet_video
from acoustic_image_generation_tpu.models import vggish as jvggish
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch import models
from acoustic_image_generation_tpu_torch.core import tf1_import
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from task_parity import with_normals
from torch_threads import few_torch_threads  # noqa: F401

TOL = 1e-5


def randomized(module, seed):
    """``module`` with random weights and every 1-D tensor (biases, BN
    parameters and statistics) drawn away from its initial value."""
    init_modules(module, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for _, t in (*module.named_parameters(), *module.named_buffers()):
            if t.dim() == 1:
                if bool((t > 0).all()):  # variances
                    t.mul_(0.75 + 0.5 * torch.rand(t.shape, generator=g))
                else:
                    t.add_(0.05 * torch.randn(t.shape, generator=g))
    return module


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{err:.3e} of {scale:.3e}"


def equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            equal_trees(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def round_trip(module, fresh):
    """``load_flax`` of ``module``'s trees into ``fresh``, then ``to_flax``
    of it: the trees again, to the bit."""
    params, stats = bridge.to_flax(module)
    bridge.load_flax(fresh, params, stats)
    again = bridge.to_flax(fresh)
    equal_trees(again[0], params)
    equal_trees(again[1], stats)
    return params, stats


@pytest.mark.parametrize("name, latent, batch", [("DecoderVideo", 128, 1), ("DecoderEnergy", 128, 2),
                                                  ("DecoderAudio", 256, 1)])
def test_decoder_matches_jax(name, latent, batch):
    port = randomized(getattr(models, name)(latent), 3)
    params, _ = round_trip(port, getattr(models, name)(latent))
    z = np.random.default_rng(4).standard_normal((batch, latent)).astype(np.float32)
    want = jax.jit(getattr(jdecoders, name)().apply)({"params": params}, jnp.asarray(z))
    with torch.no_grad():
        got = port(torch.from_numpy(z))
    close(got.numpy(), want)


@pytest.mark.parametrize("shape", [(16, 8), (2, 6, 5, 8)], ids=["vectors", "maps"])
def test_mean_std_matches_jax_in_train_and_eval(shape):
    port = randomized(models.MeanStd(shape[-1]), 5)
    params, stats = round_trip(port, models.MeanStd(shape[-1]))
    x = (3.0 + 2.0 * np.random.default_rng(6).standard_normal(shape)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    want_eval = jdecoders.MeanStd(use_running_average=True).apply(variables, jnp.asarray(x))
    want, updated = jdecoders.MeanStd().apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    with torch.no_grad():
        close(port(torch.from_numpy(x)).numpy(), want_eval)
        close(port(torch.from_numpy(x), train=True).numpy(), want)
    new_stats = bridge.to_flax(port)[1]["BatchNorm_0"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_stats[k], updated["batch_stats"]["BatchNorm_0"][k], rtol=1e-6, atol=1e-7)
        assert not np.allclose(new_stats[k], stats["BatchNorm_0"][k])  # the running average moved


def vggish_checkpoint(port):
    """A TF1 VGGish checkpoint's tensors for ``port``'s weights, under the
    reference's names: slim ``weights``/``biases``, the ``slim.repeat``
    scopes ``conv3``, ``conv4``, ``fc1``."""
    params, _ = bridge.to_flax(port)
    ckpt = {}
    for name, leaves in params.items():
        scope = name.split("_")[0] if "_" in name else None
        path = f"vggish/{scope}/{name}" if scope else f"vggish/{name}"
        ckpt[f"{path}/weights"] = leaves["kernel"]
        ckpt[f"{path}/biases"] = leaves["bias"]
    return ckpt


def test_vggish_from_a_tf1_checkpoint_matches_jax():
    src = randomized(models.VGGish(), 7)
    ckpt = vggish_checkpoint(src)
    assert "vggish/conv3/conv3_1/weights" in ckpt and "vggish/fc1/fc1_2/biases" in ckpt
    params, stats = tf1_import.import_scope(ckpt, "vggish")
    jparams, jstats = jtf1_import.import_scope(ckpt, "vggish")
    equal_trees(params, jparams)
    assert stats == jstats == {}
    port = models.VGGish()
    bridge.load_flax(port, params, {})
    round_trip(port, models.VGGish())
    x = np.random.default_rng(8).standard_normal((2, 96, 64)).astype(np.float32)
    want = jax.jit(jvggish.VGGish().apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        assert got.shape == (2, 1, 1, 4096)
        close(got.numpy(), want)
        close(port(torch.from_numpy(x[..., None])).numpy(), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unet_video_skip_matches_jax_with_its_noise(train):
    port = randomized(models.UNetVideoSkip(), 9)
    params, stats = round_trip(port, models.UNetVideoSkip())
    x = np.random.default_rng(10).random((2, 224, 298, 3), dtype=np.float32)
    jmodel = junet_video.UNetVideoSkip()

    def apply(p, s, v):
        out, new = jmodel.apply({"params": p, "batch_stats": s}, v, train=train, rngs={"latent": jax.random.key(11)},
                                mutable=["batch_stats"])
        return out, new["batch_stats"]

    (want, want_stats), draws = with_normals(apply)(params, stats, jnp.asarray(x))
    assert len(draws) == 1 and draws[0].shape == (2, 128)
    with torch.no_grad():
        got = port(torch.from_numpy(x), eps=torch.from_numpy(np.array(draws[0])), train=train)
    assert got.output.shape == (2, 224, 298, 3) and got.z.shape == (2, 128)
    for g, w in ((got.output, want.output), (got.logits, want.logits), (got.z, want.z), (got.mean, want.mean),
                 (got.std, want.std), (got.features, want.features)):
        close(g.numpy(), w, 1e-3 if train else TOL)
    new_stats = bridge.to_flax(port)[1]
    moved = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a, b: float(np.abs(a - b).max()), new_stats,
                                                             stats))
    assert (max(moved) > 0) == train
    for a, b in zip(jax.tree_util.tree_leaves(new_stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
