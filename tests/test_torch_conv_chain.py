"""The port's conv_chain (its plain versions, which the wrapper and the
autograd Function run on the CPU), forward and backward, against the JAX
Pallas kernels in interpret mode and their XLA oracle.

The cases are those of the Pallas kernel's own test: a thin input, a single
conv, odd 13/11 channels with the last conv un-ReLU'd, and a depth-3 chain.
Tolerance: f32 at 1e-5 (summation order only); bf16 at 2e-2 (plus one
rounding of each layer's output to bf16, 1 ulp = 2^-8 relative). bf16
parameter grads at 1e-2 of the largest grad, as the Pallas test holds its
kernel against the oracle: the two round the cotangent at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.ops import pallas_conv as pc
from acoustic_image_generation_tpu_torch.ops import conv_chain as cc

CASES = [
    (2, 9, 12, (12, 16, 16), (True, True)),
    (2, 6, 8, (16, 24), (True,)),
    (1, 5, 7, (9, 13, 11), (True, False)),
    (4, 4, 4, (8, 8, 8, 8), (True, True, True)),
]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _chain(case):
    n, h, w, chans, _ = case
    rng = np.random.default_rng(sum(chans) + n * h * w)
    x = rng.standard_normal((n, h, w, chans[0])).astype(np.float32)
    weights = [
        (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
        for ci, co in zip(chans[:-1], chans[1:])
    ]
    biases = [(rng.standard_normal((c,)) * 0.1).astype(np.float32) for c in chans[1:]]
    return x, weights, biases


@pytest.mark.parametrize("case", CASES, ids=["thin", "single", "odd", "depth3"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_pallas_and_reference(case, dtype):
    jdt, tdt = DTYPES[dtype]
    relu = case[-1]
    x, weights, biases = _chain(case)
    xj = jnp.asarray(x).astype(jdt)
    wj = tuple(jnp.asarray(w) for w in weights)
    bj = tuple(jnp.asarray(b) for b in biases)
    pallas = np.asarray(pc.conv_chain(xj, wj, bj, relu, True).astype(jnp.float32))
    reference = np.asarray(pc.conv_chain_reference(xj, wj, bj, relu).astype(jnp.float32))

    packed = [cc.pack_hwio(torch.from_numpy(w)).to(tdt) for w in weights]
    got = cc.conv_chain(
        torch.from_numpy(x).to(tdt), packed, [torch.from_numpy(b) for b in biases], relu
    )
    assert got.dtype == tdt and got.shape == (*x.shape[:3], weights[-1].shape[-1])
    assert got.is_contiguous()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), pallas, **tol)
    np.testing.assert_allclose(got.float().numpy(), reference, **tol)


def test_pack_roundtrip_and_checks():
    w = torch.randn(3, 3, 5, 7)
    packed = cc.pack_hwio(w)
    assert packed.shape == (45, 7)
    torch.testing.assert_close(cc.unpack_oihw(packed), w.permute(3, 2, 0, 1))
    x = torch.randn(1, 4, 4, 5)
    b = torch.zeros(7)
    with pytest.raises(ValueError):
        cc.conv_chain(x, [packed[:-9]], [b], (True,))
    with pytest.raises(ValueError):
        cc.conv_chain(x, [packed], [torch.zeros(6)], (True,))
    with pytest.raises(TypeError):
        cc.conv_chain(x.double(), [packed.double()], [b], (True,))
    before = cc.conv_chain.launches
    cc.conv_chain(x, [packed], [b], (True,))
    assert cc.conv_chain.launches == before


def _cotangent(case, shape):
    return np.random.default_rng(sum(case[3])).standard_normal(shape).astype(np.float32)


def _port_grads(case, x, weights, biases, tdt, cot, x_grad=True):
    relu = case[-1]
    xt = torch.from_numpy(x).to(tdt).requires_grad_(x_grad)
    ws = [cc.pack_hwio(torch.from_numpy(w)).requires_grad_(True) for w in weights]
    bs = [torch.from_numpy(b).requires_grad_(True) for b in biases]
    y = cc.conv_chain(xt, ws, bs, relu)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    dws = [cc.unpack_oihw(w.grad).permute(2, 3, 1, 0).numpy() for w in ws]  # back to HWIO
    return (xt.grad, dws, [b.grad.numpy() for b in bs])


def _jax_grads(fn, case, x, weights, biases, jdt, cot):
    relu = case[-1]

    def f(x, ws, bs):
        return jnp.sum(fn(x, ws, bs, relu).astype(jnp.float32) * cot)

    return jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x).astype(jdt), tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray, biases))
    )


@pytest.mark.parametrize("case", CASES, ids=["thin", "single", "odd", "depth3"])
def test_grads_match_jax_f32(case):
    """Autograd through the port's Function (plain forward and backward) vs
    jax.grad of the XLA oracle, f32, with a random cotangent."""
    x, weights, biases = _chain(case)
    cot = _cotangent(case, (*x.shape[:3], weights[-1].shape[-1]))
    gx, gw, gb = _port_grads(case, x, weights, biases, torch.float32, cot)
    jx, jw, jb = _jax_grads(pc.conv_chain_reference, case, x, weights, biases, jnp.float32, cot)
    tol = dict(rtol=1e-5, atol=1e-5)
    assert gx.dtype == torch.float32 and all(w.dtype == np.float32 for w in gw)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jx), **tol)
    for a, b in zip(gw + gb, list(jw) + list(jb)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("case", CASES[::2], ids=["thin", "odd"])
def test_grads_match_pallas_bf16(case):
    """bf16: the port's plain backward vs the interpret-mode Pallas
    backward, dW and db in f32 from f32 master weights."""
    x, weights, biases = _chain(case)
    cot = _cotangent(case, (*x.shape[:3], weights[-1].shape[-1]))
    kernel = lambda x, ws, bs, relu: pc.conv_chain(x, ws, bs, relu, True)  # noqa: E731
    jx, jw, jb = _jax_grads(kernel, case, x, weights, biases, jnp.bfloat16, cot)
    gx, gw, gb = _port_grads(case, x, weights, biases, torch.bfloat16, cot)
    assert gx.dtype == torch.bfloat16 and all(w.dtype == np.float32 for w in gw)
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(jx, np.float32), rtol=2e-2, atol=2e-2)
    for a, b in zip(gw + gb, list(jw) + list(jb)):
        b = np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2)


def test_backward_skips_the_input_grad_it_is_not_asked_for():
    case = CASES[0]
    x, weights, biases = _chain(case)
    cot = _cotangent(case, (*x.shape[:3], weights[-1].shape[-1]))
    gx, gw, gb = _port_grads(case, x, weights, biases, torch.float32, cot, x_grad=False)
    assert gx is None
    _, fw, fb = _port_grads(case, x, weights, biases, torch.float32, cot)
    for a, b in zip(gw + gb, fw + fb):
        np.testing.assert_array_equal(a, b)
    xt = torch.from_numpy(x)
    ws = [cc.pack_hwio(torch.from_numpy(w)) for w in weights]
    acts = cc._reference_layers(xt, ws, [torch.from_numpy(b) for b in biases], case[-1])
    dx, dws, dbs = cc.conv_chain_backward(xt, acts, ws, torch.from_numpy(cot), case[-1], False)
    assert dx is None and len(dws) == len(dbs) == len(ws)
    assert cc.conv_chain_backward.launches == 0  # the CPU takes the plain version


def test_pack_transposed_is_the_data_grad_weight():
    """conv3x3(g, pack_transposed(w)) == the data grad of conv3x3(x, w)."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 7)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 6, 8, 7)).astype(np.float32))
    packed = cc.pack_hwio(w)
    want = torch.nn.grad.conv2d_input((2, 5, 6, 8), cc.unpack_oihw(packed), g.permute(0, 3, 1, 2), padding=1)
    zero = torch.zeros(5)
    got = cc.conv_chain_reference(g, [cc.pack_transposed(packed)], [zero], (False,))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-5)
