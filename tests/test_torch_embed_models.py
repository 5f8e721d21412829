"""The embedding family's models against the JAX package, in f32 on the
CPU: the BN variant of ``ConvConvPool`` (every pool geometry the family
uses, SAME and VALID, square and (2,3)/(3,2) kernels) and the three VAEs
at full width on 2 seconds, in train and eval mode, with JAX's weights
(biases and BN parameters and statistics drawn away from their initial
values) carried across by ``bridge.load_flax``.

Tolerances, and why: the same f32 convolutions summed in another order.
The BN block: 1e-5 relative (and absolute, for values near 0). The VAEs in
eval mode: outputs, logits, means, stds and features within 1e-4 of each
tensor's largest entry (read: 5e-7 on the audio VAE). In train mode 1e-3,
and the running averages within 1e-3 relative: each train-mode BN divides
by a batch variance taken as E[x^2] - E[x]^2 (flax's fast variance), whose
cancellation magnifies any rounding gap through the decoder's 16 BNs. JAX
against itself, eager against jitted, reads 9.8e-5 on the audio VAE's
output; the port against jitted JAX 2.2e-4 (its features 9e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.models.blocks import ConvConvPool as JaxCCP
from acoustic_image_generation_tpu.models.unet_ac import UNetAcoustic as JaxAcoustic
from acoustic_image_generation_tpu.models.unet_sound import UNetSound as JaxSound
from acoustic_image_generation_tpu.models.unet_video import UNetVideo as JaxVideo
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.blocks import ConvConvPool
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetVideo
from torch_threads import few_torch_threads  # noqa: F401

LATENT = 128


def perturb(tree, rng):
    """Non-trivial biases, BN scales and shifts, and running statistics, so
    that each of them is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "bias":
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "scale":
            v = (0.75 + 0.5 * rng.random(v.shape)).astype(np.float32)
        elif k == "mean":
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "var":
            v = (0.5 + rng.random(v.shape)).astype(np.float32)
        out[k] = v
    return out


def _peak(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _port(module, variables):
    params, stats = perturb(variables["params"], np.random.default_rng(1)), {}
    if "batch_stats" in variables:
        stats = perturb(variables["batch_stats"], np.random.default_rng(2))
    bridge.load_flax(module, params, stats)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


POOLS = {
    "sound_layer1": ((3, 3), (2, 2), "VALID"),
    "sound_layer2": ((3, 3), (2, 2), "SAME"),
    "video_layer1": ((3, 3), (3, 3), "VALID"),
    "video_layer3": ((2, 3), (3, 3), "VALID"),
    "kernel_3x2_same": ((3, 2), (2, 2), "SAME"),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_bn_conv_conv_pool_matches_flax(pool, train):
    kernel, strides, padding = POOLS[pool]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 17, 23, 5)).astype(np.float32)
    jm = JaxCCP((6, 7), pool=True, batch_norm=True, pool_kernel=kernel, pool_strides=strides,
                pool_padding=padding)
    variables = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    port = ConvConvPool(5, (6, 7), pool=True, batch_norm=True, pool_kernel=kernel, pool_strides=strides,
                        pool_padding=padding)
    variables = _port(port, variables)
    (conv, p), mut = jm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])
    with torch.no_grad():
        got_conv, got_p = port(torch.from_numpy(x), train)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_conv.numpy(), np.asarray(conv), **tol)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(p), **tol)
    got_stats = bridge.to_flax(port)[1]
    for name in ("bn_1", "bn_2", "bn_pool_2"):
        for key in ("mean", "var"):
            np.testing.assert_allclose(got_stats[name][key], np.asarray(mut["batch_stats"][name][key]),
                                       **tol, err_msg=f"{name}/{key}")
    if not train:  # eval mode leaves the running averages alone
        for name in ("bn_1", "bn_2", "bn_pool_2"):
            np.testing.assert_array_equal(got_stats[name]["var"], variables["batch_stats"][name]["var"])


def _check_vae(jm, port, x, train):
    tol = 1e-3 if train else 1e-4
    variables = jm.init({"params": jax.random.key(0)}, jnp.asarray(x[:1]), train=False)
    variables = _port(port, variables)
    has_bn = "batch_stats" in variables
    if has_bn:
        out, mut = jax.jit(lambda v, x: jm.apply(v, x, sample=False, train=train, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    else:
        out = jax.jit(lambda v, x: jm.apply(v, x, sample=False, train=train))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train)
    for name in ("output", "logits", "mean", "std", "features"):
        _peak(getattr(got, name).numpy(), getattr(out, name), tol, name)
    np.testing.assert_array_equal(got.z.numpy(), got.mean.numpy())  # no noise: z = mean
    if has_bn:
        got_stats = bridge.to_flax(port)[1]
        want = dict(jax.tree_util.tree_leaves_with_path(mut["batch_stats"]))
        for path, value in jax.tree_util.tree_leaves_with_path(got_stats):
            np.testing.assert_allclose(value, np.asarray(want[path]), rtol=tol, atol=tol,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet_acoustic_matches_jax(train):
    x = np.random.default_rng(3).random((2, 36, 48, 12)).astype(np.float32)
    _check_vae(JaxAcoustic(channels=12, latent_dim=LATENT), UNetAcoustic(12, LATENT), x, train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet_sound_matches_jax(train):
    x = (np.random.default_rng(4).random((2, 193, 257, 1)) * 5).astype(np.float32)
    _check_vae(JaxSound(variant="large", latent_dim=LATENT), UNetSound("large", LATENT), x, train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet_video_matches_jax(train):
    x = np.random.default_rng(5).random((2, 224, 298, 3)).astype(np.float32)
    _check_vae(JaxVideo(latent_dim=LATENT), UNetVideo(LATENT), x, train)


def test_unet_split_methods_and_unported_variants():
    x = torch.from_numpy(np.random.default_rng(6).random((2, 36, 48, 12)).astype(np.float32))
    m = UNetAcoustic(12, LATENT)
    g = torch.Generator().manual_seed(0)
    for mod in m.modules():
        if mod is not m and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(g)
    with torch.no_grad():
        out = m(x)
        z, mean, std, feat = m.encode(x)
        torch.testing.assert_close(feat, out.features, rtol=0, atol=0)
        torch.testing.assert_close(m.decode(z), out.output, rtol=0, atol=0)
        eps = torch.randn((2, LATENT), generator=g)
        torch.testing.assert_close(m.from_features(feat, eps=eps).z, mean + std * eps, rtol=0, atol=0)
    assert feat.shape == (2, 12, 16, 133) and out.output.shape == x.shape
    # the small variant is ported (tests/test_torch_reconstruct.py); no third one exists
    assert UNetSound("small").variant == "small"
    with pytest.raises(ValueError, match="medium"):
        UNetSound("medium")
