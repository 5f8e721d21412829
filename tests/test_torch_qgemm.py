"""The port's fused int8 1x1 conv (``ops/qgemm.py``; on the CPU its plain
version) against the JAX package's ``fused_q1x1``, run as its own tests run
it: the Pallas kernel in interpret mode, and its XLA twin
``xla_q1x1_reference`` (models/quant.py's unfused epilogue).

Tolerance: at most one int8 quantum on under 1% of the entries, JAX's own
bound (``tests/test_pallas_qgemm.py``). The s8 x s8 -> s32 sum is exact on
every side; the epilogues differ in where f32 rounds (XLA on the CPU fuses
``acc * f + b`` into an FMA, torch does not; the twin does not fold the
requant scale), so an entry that lies within an ulp of a rounding tie can
land one quantum apart. The output amax is set so that about 1% of the
outputs clip, and the test checks that fewer than 5% do: an all-saturated
output would compare nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.ops.pallas_qgemm import fused_q1x1 as jax_fused_q1x1
from acoustic_image_generation_tpu.ops.pallas_qgemm import xla_q1x1_reference
from acoustic_image_generation_tpu_torch.ops import qgemm
from torch_threads import few_torch_threads  # noqa: F401

A_AMAX, RES_AMAX = 3.7, 2.2


def _case(seed, shape, relu, use_res):
    b, h, w, k, n = shape
    rs = np.random.RandomState(seed)
    x = rs.randint(-127, 128, (b, h, w, k)).astype(np.int8)
    kernel = rs.randint(-127, 128, (1, 1, k, n)).astype(np.int8)
    scale = (rs.rand(n) * 0.01 + 1e-3).astype(np.float32)
    bias = (rs.randn(n) * 0.5).astype(np.float32)
    res = rs.randint(-127, 128, (b, h, w, n)).astype(np.int8) if use_res else None
    # the output amax: about 1% of the float results lie above it
    y = x.reshape(-1, k).astype(np.float64) @ kernel.reshape(k, n).astype(np.float64)
    y = y * (A_AMAX / 127 * scale) + bias
    if use_res:
        y = y + res.reshape(-1, n) * (RES_AMAX / 127)
    if relu:
        y = np.maximum(y, 0)
    out_amax = np.float32(np.quantile(np.abs(y), 0.99))
    return x, kernel, scale, bias, res, out_amax


def _port(x, kernel, scale, bias, res, out_amax, relu):
    k, n = kernel.shape[2:]
    t = torch.from_numpy
    got = qgemm.fused_q1x1(
        t(x), t(np.ascontiguousarray(kernel.reshape(k, n).T)), t(scale), t(bias),
        torch.tensor(A_AMAX), torch.tensor(out_amax), relu=relu,
        residual=None if res is None else t(res), residual_amax=None if res is None else torch.tensor(RES_AMAX),
    )
    return got.numpy()


@pytest.mark.parametrize("use_res", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("shape", [(3, 7, 11, 128, 256), (5, 5, 7, 64, 256)], ids=["m231", "ragged_m175_k64"])
def test_fused_q1x1_matches_jax(shape, relu, use_res):
    x, kernel, scale, bias, res, out_amax = _case(0, shape, relu, use_res)
    layer = {"w": jnp.asarray(kernel), "scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    kw = dict(relu=relu, residual=None if res is None else jnp.asarray(res),
              residual_amax=jnp.float32(RES_AMAX) if use_res else None)
    pallas = np.asarray(jax_fused_q1x1(jnp.asarray(x), layer, jnp.float32(A_AMAX), jnp.float32(out_amax),
                                       interpret=True, **kw))
    twin = np.asarray(xla_q1x1_reference(jnp.asarray(x), layer, jnp.float32(A_AMAX), jnp.float32(out_amax), **kw))
    launches = qgemm.qgemm_s8.launches
    got = _port(x, kernel, scale, bias, res, out_amax, relu)
    assert qgemm.qgemm_s8.launches == launches  # the CPU runs the plain version

    assert got.dtype == np.int8 and got.shape == shape[:3] + (shape[4],)
    clipped = float((np.abs(got.astype(np.int32)) == 127).mean())
    assert 0 < clipped < 0.05, clipped
    for want in (pallas, twin):
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() < 0.01, (diff > 0).mean()


def test_requant_rounds_half_to_even_and_clamps():
    """``round`` as ``jnp.round`` (half to even; C's ``roundf`` rounds half
    away from zero), then the clamp to +-127."""
    acc = torch.tensor([[1], [3], [5], [-1], [-3], [400], [-400]], dtype=torch.int32)
    fb = torch.tensor([[0.5], [0.0]])
    got = qgemm.requant(acc, fb, torch.zeros(1), None, relu=False)
    assert got.dtype == torch.int8
    assert got.flatten().tolist() == [0, 2, 2, 0, -2, 127, -127]
    assert qgemm.requant(acc, fb, torch.zeros(1), None, relu=True).flatten().tolist() == [0, 2, 2, 0, 0, 127, 0]


def test_qgemm_s8_checks_its_arguments():
    x = torch.zeros((20, 64), dtype=torch.int8)
    w = torch.zeros((32, 64), dtype=torch.int8)
    f = torch.ones(32)
    one = torch.tensor(1.0)
    assert qgemm.qgemm_s8(x, w, f, f, one, relu=True).shape == (20, 32)
    with pytest.raises(TypeError):
        qgemm.qgemm_s8(x.float(), w, f, f, one, relu=True)
    with pytest.raises(ValueError):
        qgemm.qgemm_s8(x, w[:, :32], f, f, one, relu=True)
    with pytest.raises(ValueError):
        qgemm.qgemm_s8(x, w, f[:16], f, one, relu=True)
    with pytest.raises(ValueError):
        qgemm.qgemm_s8(x, w, f, f, one, relu=True, residual=torch.zeros((20, 32), dtype=torch.int8))
    with pytest.raises(ValueError):
        qgemm.qgemm_s8(x.to("meta"), w.to("meta"), f.to("meta"), f.to("meta"), one, relu=True)
