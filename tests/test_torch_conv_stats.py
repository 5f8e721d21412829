"""The port's ``matmul_stats`` (its plain version and autograd rule, which
the CPU runs) and the ResNet's ``fused_bn_stats`` train path against the
JAX package: the Pallas kernel in interpret mode, and the JAX ResNet50 with
``fused_bn_stats=True``.

Tolerances: f32 products and sums at 1e-5 relative (summation order); the
sums of squares at 1e-4 (a sum of 300 squares); bf16 ``y`` at one bf16
rounding (2^-8 relative) on top; the ResNet's output and updated statistics
at 1e-4 (five layers of f32 arithmetic in another order). In bf16 one fused
conv + BN is held to one bf16 ulp (it agrees bit for bit here), so a cast
in another place than JAX's ``_TrainBN`` fails it; the whole bf16 ResNet
only to 0.1 of its largest output and 5e-3 of each statistic's largest
entry, since a y that rounds to the neighbouring bf16 value moves every
later BN (2.2e-2 and 5.9e-4 measured), which still fails a swapped scale
and shift or a statistic that is not subtracted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.models.resnet import ResNet50 as JaxResNet50
from acoustic_image_generation_tpu.models.resnet import _ConvBN as JaxConvBN
from acoustic_image_generation_tpu.ops import pallas_conv_stats as jcs
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.resnet import ConvBN, ResNet50
from acoustic_image_generation_tpu_torch.ops import conv_stats as cs

# (M, K, N): M is ragged against the Pallas kernel's 512-row tile
SHAPES = [(300, 64, 192), (1100, 32, 48)]


@pytest.mark.parametrize("shape", SHAPES, ids=["ragged300", "ragged1100"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_stats_matches_pallas(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jy, js, jss = jax.device_get(
        jcs.matmul_stats(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), interpret=True)
    )
    y, s, ss = cs.matmul_stats(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
    assert y.dtype == tdt and s.dtype == ss.dtype == torch.float32
    ytol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=2**-8, atol=1e-2)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **ytol)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-4)
    assert cs.matmul_stats.launches == 0  # the CPU takes the plain version


def test_conv1x1_batch_stats_matches_pallas():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 11, 16)).astype(np.float32)  # 154 rows, ragged
    k = rng.standard_normal((1, 1, 16, 24)).astype(np.float32)
    jy, jm, jv = jax.device_get(jcs.conv1x1_batch_stats(jnp.asarray(x), jnp.asarray(k)))
    y, mean, var = cs.conv1x1_batch_stats(torch.from_numpy(x), torch.from_numpy(k.reshape(16, 24)))
    assert y.shape == (2, 7, 11, 24)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), jv, rtol=1e-4, atol=1e-5)


def test_matmul_stats_grads_match_jax():
    """The Function's backward (the transposed JVP, in torch.matmul) vs
    jax.grad through JAX's custom JVP, for a loss that reads y, the sums and
    the sums of squares."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    cy = rng.standard_normal((40, 6)).astype(np.float32)
    cs_, css = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)

    def f(x, w):
        y, s, ss = jcs.matmul_stats(x, w)
        return jnp.sum(y * cy) + jnp.sum(s * cs_) + jnp.sum(ss * css) * 1e-2

    jx, jw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y, s, ss = cs.matmul_stats(xt, wt)
    ((y * torch.from_numpy(cy)).sum() + (s * torch.from_numpy(cs_)).sum()
     + (ss * torch.from_numpy(css)).sum() * 1e-2).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-4)


def _fused_resnet_pair(dtype):
    """(port output, port batch_stats tree, JAX output, JAX batch_stats) of
    ResNet50(fused_bn_stats=True), one unit per block at narrow widths,
    train mode, from the same variables with non-trivial BN leaves."""
    rng = np.random.default_rng(1)
    x = rng.random((2, 64, 80, 3)).astype(np.float32)
    blocks = ((8, 1, 1), (16, 1, 2), (32, 1, 2), (64, 1, 1))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = JaxResNet50(blocks=blocks, fused_bn_stats=True, dtype=jdt)
    variables = jmodel.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    # non-trivial BN parameters and statistics, so scale and shift are tested
    leaves, tree = jax.tree_util.tree_flatten(variables)
    leaves = [np.asarray(v) + (0.1 * rng.random(v.shape).astype(np.float32) if v.ndim == 1 else 0)
              for v in leaves]
    variables = jax.tree_util.tree_unflatten(tree, leaves)
    want, mut = jax.device_get(jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"]))

    holder = torch.nn.Module()
    holder.resnet = ResNet50(blocks, fused_bn_stats=True, dtype=tdt)
    bridge.load_flax(holder, {"resnet": variables["params"]}, {"resnet": variables["batch_stats"]})
    fused = [m for m in holder.resnet.modules() if getattr(m, "fused_stats", False)]
    assert len(fused) == 4 * 2 + 2  # conv1 + conv3 of each unit, block1/4 shortcuts
    got = holder.resnet(torch.from_numpy(x), train=True)
    assert got.dtype == tdt
    _, got_stats = bridge.to_flax(holder)
    flat_want = jax.tree_util.tree_leaves_with_path(mut["batch_stats"])
    flat_got = jax.tree_util.tree_leaves_with_path(got_stats["resnet"])
    assert [p for p, _ in flat_want] == [p for p, _ in flat_got]
    return got.detach().float().numpy(), flat_got, np.asarray(want, np.float32), flat_want


def test_fused_bn_stats_resnet_train_forward_matches_jax():
    """ResNet50(fused_bn_stats=True), one unit per block at narrow widths,
    train mode: the output and every updated running statistic vs JAX's
    fused path (Pallas interpret mode), from the same variables."""
    got, flat_got, want, flat_want = _fused_resnet_pair("f32")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for (path, a), (_, b) in zip(flat_want, flat_got):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=str(path))


def test_fused_bn_stats_resnet_train_forward_matches_jax_bf16():
    """The same in bf16, at the whole-network tolerance of the module
    docstring."""
    got, flat_got, want, flat_want = _fused_resnet_pair("bf16")
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()
    for (path, a), (_, b) in zip(flat_want, flat_got):
        assert np.abs(b - a).max() <= 5e-3 * np.abs(a).max(), path


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
def test_fused_conv_bn_bf16_matches_jax(relu):
    """One fused 1x1 conv + train-mode BN in bf16 (the port's ConvBN with
    ``fused_stats``, ``BatchNorm.forward_stats``) vs JAX's ``_ConvBN`` with
    ``fused_stats`` (``_Conv1x1Stats`` + ``_TrainBN``, Pallas interpret
    mode) on the same bf16 input, whose channel means are far from zero:
    the output within one bf16 ulp, the updated statistics at f32 rounding."""
    rng = np.random.default_rng(2)
    ci, co = 32, 48
    x = (np.maximum(rng.standard_normal((2, 15, 19, ci)), 0) + 0.5).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jm = JaxConvBN(co, (1, 1), 1, relu=relu, fused_stats=True, dtype=jnp.bfloat16)
    variables = jm.init(jax.random.key(0), xb, train=False)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.5 * rng.random(a.shape).astype(np.float32) if a.ndim == 1 else 0),
        variables,
    )
    want, mut = jax.device_get(jm.apply(variables, xb, train=True, mutable=["batch_stats"]))
    want = np.asarray(want, np.float32)

    m = ConvBN(ci, co, (1, 1), 1, relu=relu, fused_stats=True, dtype=torch.bfloat16)
    params, stats = variables["params"], variables["batch_stats"]["BatchNorm"]
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        m.bn.weight.copy_(torch.from_numpy(np.asarray(params["BatchNorm"]["scale"])))
        m.bn.bias.copy_(torch.from_numpy(np.asarray(params["BatchNorm"]["bias"])))
        m.bn.running_mean.copy_(torch.from_numpy(np.asarray(stats["mean"])))
        m.bn.running_var.copy_(torch.from_numpy(np.asarray(stats["var"])))
        got = m(torch.from_numpy(x).to(torch.bfloat16), train=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=1e-6)
    new = mut["batch_stats"]["BatchNorm"]
    np.testing.assert_allclose(m.bn.running_mean.numpy(), new["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.bn.running_var.numpy(), new["var"], rtol=1e-6, atol=1e-7)
