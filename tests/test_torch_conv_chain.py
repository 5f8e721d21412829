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


# ------------------------------------------- layouts of the bf16 CUDA kernels
#
# The kernels cannot run here; what surrounds them can. The tests below hold
# the host-side layouts (channel padding, the K-major packs, the tile plan,
# the weight grad's slices) against the JAX packing and reference, and the
# plain version of the backward's fused step against JAX's backward kernel.

WIDTHS = [12, 133, 256]


def kmajor_columns(cin_p: int) -> torch.Tensor:
    """(9, cin_p) column of (tap, channel) in the bf16 implicit GEMM's K
    order, chunk by chunk as ``chunk_tap`` in ``csrc/conv_chain.cu`` maps
    them: 16-byte chunks of 8 channels, in slices of up to 8 chunks (64
    channels), and within a slice tap by tap."""
    cpt = cin_p // 8
    full, rem = divmod(cpt, 8)
    tap = torch.arange(9).view(9, 1)
    q = torch.arange(cpt).view(1, cpt)
    b, r = q // 8, q % 8
    pos = torch.where(b < full, b * 72 + tap * 8 + r, full * 72 + tap * rem + (q - full * 8))
    return (pos.view(9, cpt, 1) * 8 + torch.arange(8)).view(9, cin_p)


def _emulate_igemm(xp, wk, cols):
    """The bf16 implicit GEMM on the CPU in f32: K ordered (tap, padded
    channel) as the kernel walks it, ``wk`` from ``pack_kmajor``."""
    n, h, w, cip = xp.shape
    xpad = torch.nn.functional.pad(xp.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    taps = [xpad[:, :, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    a = torch.stack(taps, 1).permute(0, 3, 4, 1, 2).reshape(n * h * w, 9 * cip)
    ak = torch.zeros(n * h * w, wk.shape[1])
    ak[:, kmajor_columns(cip).reshape(-1)] = a
    return (ak @ wk.float().T)[:, :cols].reshape(n, h, w, cols)


def test_pad_channels():
    x = torch.randn(2, 3, 4, 133)
    p = cc.pad_channels(x)
    assert p.shape == (2, 3, 4, 136) and p.is_contiguous()
    assert torch.equal(p[..., :133], x) and not p[..., 133:].any()
    view = p[..., :133]
    assert cc.pad_channels(view, reuse=True).data_ptr() == p.data_ptr()  # taken back whole
    assert cc.pad_channels(view).data_ptr() != p.data_ptr()  # unless asked: a fresh zeroed copy
    same = torch.randn(1, 2, 2, 128)
    assert cc.pad_channels(same) is same
    assert [cc.padded_width(c) for c in (12, 64, 128, 133, 256)] == [16, 64, 128, 136, 256]


@pytest.mark.parametrize("ci", WIDTHS)
def test_pack_kmajor_matches_jax_pack_w3(ci):
    """Row co, column ``kmajor_columns(cip)[tap, c]`` of the K-major pack is
    JAX's ``_pack_w3(w)[dy, dx*Ci + c, co]``; zero in every padded place."""
    co = 24
    w = np.random.default_rng(ci).standard_normal((3, 3, ci, co)).astype(np.float32)
    cip = cc.padded_width(ci)
    wk = cc.pack_kmajor(cc.pack_hwio(torch.from_numpy(w)), cip, 64)
    assert wk.shape == (64, -(-9 * cip // cc.STAGE_K) * cc.STAGE_K)
    w3 = np.asarray(pc._pack_w3(jnp.asarray(w), jnp.float32))  # (3, 3*Ci, Co)
    body = wk[:co, kmajor_columns(cip)].reshape(co, 3, 3, cip)
    np.testing.assert_array_equal(body[..., :ci].permute(1, 2, 3, 0).reshape(3, 3 * ci, co).numpy(), w3)
    assert not body[..., ci:].any() and not wk[co:].any() and not wk[:, 9 * cip :].any()
    # the order's slices: 64 channels x 9 taps, then what is left
    assert kmajor_columns(cip)[1, 0] == min(cip, 64)


@pytest.mark.parametrize("ci", WIDTHS)
def test_padded_pack_transposed_matches_jax_pack_w3t(ci):
    """The data grad's weights, padded: ``pack_kmajor(pack_transposed(w))``
    row c, column (tap, co) holds w flipped in space and transposed,
    which is JAX's ``_pack_w3t`` with its dy mirror (the roll's) undone."""
    co = 133
    w = np.random.default_rng(ci + 1).standard_normal((3, 3, ci, co)).astype(np.float32)
    cop = cc.padded_width(co)
    _, bn, n_tiles = cc.plan_tiles(10_000, ci)
    wt = cc.pack_kmajor(cc.pack_transposed(cc.pack_hwio(torch.from_numpy(w))), cop, bn * n_tiles)
    w3t = np.asarray(pc._pack_w3t(jnp.asarray(w), jnp.float32))  # (3, 3*Co, Ci), dx mirrored
    full = wt[:ci, kmajor_columns(cop)]  # (ci, tap, cop)
    body = full.reshape(ci, 3, 3, cop)[..., :co]  # (ci, dy', dx', co)
    want = w3t[::-1].reshape(3, 3, co, ci).transpose(3, 0, 1, 2)  # mirror dy too
    np.testing.assert_array_equal(body.numpy(), want)
    assert not full[..., co:].any() and not wt[ci:].any()


@pytest.mark.parametrize("ci", WIDTHS)
def test_padded_igemm_matches_jax_reference(ci):
    """The forward and the data grad as the kernel computes them on padded
    operands (emulated in f32) against JAX's conv_chain_reference and
    torch's data grad, at 12, 133 and 256 input channels."""
    co = 133
    rng = np.random.default_rng(ci + 2)
    x = rng.standard_normal((2, 5, 7, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    packed = cc.pack_hwio(torch.from_numpy(w))
    _, bn, n_tiles = cc.plan_tiles(70, co)
    got = _emulate_igemm(cc.pad_channels(torch.from_numpy(x)), cc.pack_kmajor(packed, cc.padded_width(ci), bn * n_tiles), co)
    want = pc.conv_chain_reference(jnp.asarray(x), (jnp.asarray(w),), (jnp.zeros(co),), (False,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    g = torch.from_numpy(rng.standard_normal((2, 5, 7, co)).astype(np.float32))
    _, bn, n_tiles = cc.plan_tiles(70, ci)
    wt = cc.pack_kmajor(cc.pack_transposed(packed), cc.padded_width(co), bn * n_tiles)
    dx = _emulate_igemm(cc.pad_channels(g), wt, ci)
    want = torch.nn.grad.conv2d_input((2, ci, 5, 7), cc.unpack_oihw(packed), g.permute(0, 3, 1, 2), padding=1)
    np.testing.assert_allclose(dx.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-4)


def test_plan_tiles():
    """One N tile of 16/64/128/136 columns up to 136 output channels, tiles
    of 128 beyond; 64-pixel blocks where 128 would not give two per SM."""
    big, small = 96 * 36 * 48, 96 * 12 * 16
    assert cc.plan_tiles(big, 128) == (128, 128, 1)
    assert cc.plan_tiles(big, 64) == (128, 64, 1)
    assert cc.plan_tiles(big, 12) == (128, 16, 1)
    assert cc.plan_tiles(small, 133) == (64, 136, 1)  # 144 blocks of 128 would not fill 132 SMs twice
    assert cc.plan_tiles(768 * 12 * 16, 133) == (128, 136, 1)
    assert cc.plan_tiles(big, 256) == (128, 128, 2)
    assert cc.plan_tiles(big, 100) == (128, 128, 1)
    assert cc.plan_tiles(small, 256) == (128, 128, 2)  # two N tiles fill the card at 128 pixels


def test_wgrad_splits():
    """bf16: about two blocks per SM over the (tap, channel) x column tiles,
    every slice at least WGRAD_MIN_STEPS stages; f32 unchanged."""
    m = 768 * 36 * 48
    for ci, co in [(12, 128), (128, 128), (256, 128), (128, 64), (133, 128), (128, 133)]:
        s = cc.wgrad_splits(m, ci, co, torch.bfloat16)
        bm, _, n_tiles = cc.wgrad_tiles(co)
        tiles = -(-9 * cc.padded_width(ci) // bm) * n_tiles
        assert tiles * s >= cc.WGRAD_BLOCKS > tiles * (s - 1)
        assert m // s >= cc.WGRAD_MIN_STEPS * cc.STAGE_K
    assert cc.wgrad_splits(4096, 256, 128, torch.bfloat16) == 2  # capped by the slice depth
    assert cc.wgrad_splits(10, 12, 16, torch.bfloat16) == 1
    assert cc.wgrad_splits(m, 128, 128, torch.float32) == -(-m // cc.WGRAD_F32_PIXELS)
    # columns: whole 64-channel atoms, 133 -> 192, wider in tiles of 128
    assert [cc.wgrad_tiles(c) for c in (13, 64, 128, 133, 256)] == [
        (256, 64, 1), (256, 64, 1), (256, 128, 1), (128, 192, 1), (256, 128, 2)]


def _fused_backward(x, acts, weights, gy, relu):
    """The bf16 CUDA backward's structure in plain torch: one gate on the
    incoming cotangent, then per layer the weight grad and the fused data
    grad (``gated_data_grad_reference``)."""
    dt = x.dtype
    k = len(weights)
    g = gy.to(dt).float()
    if relu[-1]:
        g = torch.where(acts[-1] > 0, g, 0.0)
    dbs = [None] * k
    dws = [None] * k
    dbs[-1] = g.sum(dim=(0, 1, 2))
    gq = g.to(dt)
    for i in range(k - 1, -1, -1):
        w = weights[i].to(dt)
        prev = (x if i == 0 else acts[i - 1]).float().permute(0, 3, 1, 2)
        ci, co = w.shape[0] // 9, w.shape[1]
        dw = torch.nn.grad.conv2d_weight(prev, (co, ci, 3, 3), gq.float().permute(0, 3, 1, 2), padding=1)
        dws[i] = dw.permute(2, 3, 1, 0).reshape(9 * ci, co)
        if i > 0:
            gq, dbs[i - 1] = cc.gated_data_grad_reference(gq, w, acts[i - 1], relu[i - 1])
        else:
            gq, none = cc.gated_data_grad_reference(gq, w, None, False)
            assert none is None
    return gq, dws, dbs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3]], ids=["depth2", "depth2-odd", "depth3"])
def test_fused_step_matches_pallas_backward(case, dtype):
    """The backward built on the fused step's plain version against JAX's
    ``_conv_chain_bwd`` in interpret mode, on its own forward's residuals:
    f32 at 1e-5; bf16 dx at 2e-2 and dW, db at 1e-2 of the largest grad
    (the two round the cotangent at other places)."""
    jdt, tdt = DTYPES[dtype]
    relu = case[-1]
    x, weights, biases = _chain(case)
    cot = _cotangent(case, (*x.shape[:3], weights[-1].shape[-1]))
    xj = jnp.asarray(x).astype(jdt)
    wj = tuple(map(jnp.asarray, weights))
    bj = tuple(map(jnp.asarray, biases))
    _, res = pc._conv_chain_fwd(xj, wj, bj, relu, True)
    jx, jw, jb = pc._conv_chain_bwd(relu, True, res, jnp.asarray(cot).astype(jdt))

    xt = torch.from_numpy(x).to(tdt)
    ws = [cc.pack_hwio(torch.from_numpy(w)) for w in weights]
    acts = cc._reference_layers(xt, [w.to(tdt) for w in ws], [torch.from_numpy(b) for b in biases], relu)
    gx, gw, gb = _fused_backward(xt, acts, ws, torch.from_numpy(cot), relu)
    assert gx.dtype == tdt and all(d.dtype == torch.float32 for d in gw + gb)
    gw = [cc.unpack_oihw(d).permute(2, 3, 1, 0).numpy() for d in gw]  # back to HWIO
    if dtype == "f32":
        np.testing.assert_allclose(gx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
        for a, b in zip(gw + [d.numpy() for d in gb], list(jw) + list(jb)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(jx, np.float32), rtol=2e-2, atol=2e-2)
    for a, b in zip(gw + [d.numpy() for d in gb], list(jw) + list(jb)):
        b = np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-2)
