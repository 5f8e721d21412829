"""Fused int8 1x1 conv (GEMM) of the quantized trunk: the CUDA kernel
(``csrc/qgemm_s8.cu``), its wrapper, its plain version and the NHWC wrapper.

Port of ``acoustic_image_generation_tpu/ops/pallas_qgemm.py`` (``qgemm_s8``
and ``fused_q1x1``). ``x`` s8 (M, K) times the weights gives an exact s32
sum ``acc``; then, in f32,

    y = acc * factor' + bias'  [+ residual * res_scale']  [ReLU]
    out = s8(clip(round_half_even(y), -127, 127))

where the primed coefficients carry the requant scale ``127 / out_amax``,
folded in as JAX folds it on the host: by ``_folded`` in the plain version,
by the kernel itself from the amaxes on the device, with the same f32
operations. Folding reorders two f32 roundings against models/quant.py's
unfused epilogue, so the two may differ by one int8 quantum on rare
near-tie entries.

Weights are stored (N, K), K-major: the layout the kernel's tensor-core
product reads without a transpose. JAX's kernel takes (K, N);
``bridge.load_qtrunk`` converts. The trunk is frozen, so there is no
backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from acoustic_image_generation_tpu_torch.ops import build, gemm_plan
from acoustic_image_generation_tpu_torch.ops.qconv import int_mm


def fdiv(a, b) -> torch.Tensor:
    """``a / b`` in f32, rounded once, as JAX divides. A Python number
    becomes a 0-dim tensor on the other operand's device first: torch
    computes ``number / tensor`` as ``reciprocal(tensor) * number`` (a
    quarter of the quotients then differ in the last bit) and, on CUDA,
    ``tensor / number`` as ``tensor * (1 / number)``."""
    like = a if isinstance(a, torch.Tensor) else b

    def t(v):
        if isinstance(v, torch.Tensor):
            return v.float()
        return torch.full((), v, dtype=torch.float32, device=like.device)

    return t(a) / t(b)


def _folded(factor, bias, out_amax, residual_amax, device):
    """``(fb (2, N), res_scale (1,))``: the epilogue's coefficients with the
    requant scale folded in, on ``device``, computed as JAX computes them."""
    f32 = dict(dtype=torch.float32, device=device)
    out_scale = fdiv(127.0, torch.clamp_min(torch.as_tensor(out_amax, **f32), 1e-12))
    fb = torch.stack([factor.float() * out_scale, bias.float() * out_scale])
    if residual_amax is None:
        res_scale = torch.zeros((1,), **f32)
    else:
        res_scale = (fdiv(torch.as_tensor(residual_amax, **f32), 127.0) * out_scale).reshape(1)
    return fb, res_scale


def requant(acc, fb, res_scale, residual, relu: bool) -> torch.Tensor:
    """The epilogue in torch ops, each rounding on its own: s32 ``acc`` (M, N)
    -> s8."""
    y = acc.float() * fb[0] + fb[1]
    if residual is not None:
        y = y + residual.float() * res_scale
    if relu:
        y = torch.relu(y)
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def qgemm_s8_reference(x, w, factor, bias, out_amax, *, relu, residual=None, residual_amax=None):
    """Plain version: an exact s32 product (``torch._int_mm``), then the
    folded f32 epilogue."""
    fb, res_scale = _folded(factor, bias, out_amax, residual_amax, x.device)
    return requant(int_mm(x, w), fb, res_scale, residual, relu)


@functools.cache
def _entry():
    fn = build.library("qgemm_s8").aig_qgemm_s8
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w, factor, bias, residual, residual_amax) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qgemm_s8 takes int8 x and w, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"qgemm_s8 takes x (M,K) and w (N,K), got {tuple(x.shape)}, {tuple(w.shape)}")
    n = w.shape[0]
    for name, t in (("factor", factor), ("bias", bias)):
        if t.shape != (n,) or not t.is_floating_point():
            raise ValueError(f"qgemm_s8 {name} must be float ({n},), got {t.dtype} {tuple(t.shape)}")
    if residual is not None:
        if residual.dtype != torch.int8 or residual.shape != (x.shape[0], n):
            raise ValueError(f"qgemm_s8 residual must be int8 {(x.shape[0], n)}, got "
                             f"{residual.dtype} {tuple(residual.shape)}")
        if residual_amax is None:
            raise ValueError("qgemm_s8 with a residual needs residual_amax")
    tensors = [t for t in (x, w, factor, bias, residual) if t is not None]
    if x.device.type not in ("cpu", "cuda") or any(t.device != x.device for t in tensors):
        raise ValueError(f"qgemm_s8 runs on one cpu or cuda device, got {[str(t.device) for t in tensors]}")
    if x.device.type == "cuda":
        check_kernel_args(x, w, residual)


def check_kernel_args(x, w, residual=None) -> None:
    """Raise unless the CUDA kernel takes these operands: whole 16-byte
    chunks of K and N (a K tail inside one of its k32 steps is zero-filled),
    contiguous, 16-byte aligned. Reads only shapes and addresses."""
    k, n = x.shape[1], w.shape[0]
    if k % 16 or n % 16 or k >= 2**31 or n >= 2**31:
        raise ValueError(f"the qgemm_s8 kernel takes K and N multiples of 16, got K={k}, N={n}")
    for t in (x, w, residual):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("the qgemm_s8 kernel takes contiguous, 16-byte aligned x, w and residual")


def qgemm_s8(x, w, factor, bias, out_amax, *, relu: bool, residual=None, residual_amax=None):
    """Fused ``s8[M,K] @ s8[N,K]^T`` + dequant, bias (+ residual), ReLU and
    requant to s8 (M, N).

    ``factor`` f32 (N,) is the dequant factor ``(a_amax/127) * w_scale``,
    ``bias`` f32 (N,) the folded BN bias, ``out_amax`` the output site's
    static amax; ``residual`` s8 (M, N) is dequantized by
    ``residual_amax/127`` and added before the ReLU. Amaxes are 0-dim f32
    tensors (or floats). On the CPU: the plain version. On CUDA: one launch
    of the kernel, counted in ``qgemm_s8.launches``, or an error.
    """
    _check(x, w, factor, bias, residual, residual_amax)
    if x.device.type == "cpu":
        return qgemm_s8_reference(x, w, factor, bias, out_amax, relu=relu, residual=residual,
                                  residual_amax=residual_amax)
    # the kernel folds the requant scale in itself, from the amaxes on the device
    f32 = dict(dtype=torch.float32, device=x.device)
    factor, bias = factor.to(**f32).contiguous(), bias.to(**f32).contiguous()
    out_amax = torch.as_tensor(out_amax, **f32)
    res_amax = None if residual is None else torch.as_tensor(residual_amax, **f32)
    m, k = x.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    plan = gemm_plan.plan("qgemm_s8", m, k, n, build.sm_count(x.device))
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), w.data_ptr(), factor.data_ptr(), bias.data_ptr(), out_amax.data_ptr(),
            None if res_amax is None else res_amax.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            m, k, n, int(relu), plan.bn, plan.blocks_m, plan.smem_bytes, int(plan.panel),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "qgemm_s8")
    qgemm_s8.launches += 1
    return out


qgemm_s8.launches = 0


def fused_q1x1(x, w, scale, bias, a_amax, out_amax, *, relu: bool, residual=None, residual_amax=None):
    """NHWC wrapper over :func:`qgemm_s8` for one 1x1 stride-1 layer of the
    quantized trunk: ``x`` the int8 (B, H, W, K) stream quantized with
    ``a_amax``; ``w`` (N, K) int8, ``scale`` and ``bias`` f32 (N,) the
    layer's; the result is the int8 (B, H, W, N) stream of the output site
    (``out_amax``). One call covers the unfused path's conv, residual add,
    ReLU and quantization."""
    b, h, wd, k = x.shape
    n = w.shape[0]
    factor = fdiv(torch.as_tensor(a_amax, dtype=torch.float32, device=x.device), 127.0) * scale.float()
    res2d = None if residual is None else residual.reshape(b * h * wd, n)
    out = qgemm_s8(x.reshape(b * h * wd, k), w, factor, bias, out_amax, relu=relu,
                   residual=res2d, residual_amax=residual_amax)
    return out.reshape(b, h, wd, n)
