"""The port's conv_chain (its plain version, which the wrapper runs on the
CPU) against the JAX Pallas kernel in interpret mode and its XLA oracle.

The cases are those of the Pallas kernel's own test: a thin input, a single
conv, odd 13/11 channels with the last conv un-ReLU'd, and a depth-3 chain.
Tolerance: f32 at 1e-5 (summation order only); bf16 at 2e-2 (plus one
rounding of each layer's output to bf16, 1 ulp = 2^-8 relative).
"""

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
