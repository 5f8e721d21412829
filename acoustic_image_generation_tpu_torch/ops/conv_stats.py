"""1x1 conv (a GEMM) with the batch-norm statistics of its output in the
epilogue: the CUDA kernel (``csrc/matmul_stats.cu``), its wrapper, its
plain version and its autograd rule.

Port of ``acoustic_image_generation_tpu/ops/pallas_conv_stats.py``
(``matmul_stats`` and ``conv1x1_batch_stats``). ``y = x @ w`` with operands
in the compute dtype (``x.dtype``) and f32 accumulation, plus the
per-column sum and sum of squares of the f32 accumulator, before ``y`` is
rounded to the compute dtype. ``conv1x1_batch_stats`` turns them into the
batch mean and the biased fast variance ``max(E[y^2] - E[y]^2, 0)`` that
flax's BatchNorm computes.

Gradients: JAX gives ``matmul_stats`` a custom JVP of plain matmuls; here
the same products, transposed, are the backward of ``MatmulStatsFunction``
in ``torch.matmul``, outside any kernel as JAX leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from acoustic_image_generation_tpu_torch.ops import build, gemm_plan
from acoustic_image_generation_tpu_torch.parallel import mesh

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """Plain version: ``torch.matmul`` in f32 of the operands rounded to
    ``x.dtype``, then the two column sums."""
    y = torch.matmul(x.float(), w.to(x.dtype).float())
    return y.to(x.dtype), y.sum(0), (y * y).sum(0)


@functools.cache
def _entry():
    fn = build.library("matmul_stats").aig_matmul_stats
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _matmul_stats_cuda(x, w):
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        # the blocks' column partials, summed by the kernel's second pass into s and ss
        plan = gemm_plan.plan("matmul_stats", m, k, n, build.sm_count(x.device))
        part = torch.empty((plan.blocks_m, 2, n), dtype=torch.float32, device=x.device)
        s = torch.empty((n,), dtype=torch.float32, device=x.device)
        ss = torch.empty((n,), dtype=torch.float32, device=x.device)
        tiling = (plan.bn, plan.blocks_m, plan.smem_bytes)
    else:
        part = None
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        ss = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tiling = (0, 0, 0)
    with torch.cuda.device(x.device):
        rc = _entry()(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), s.data_ptr(), ss.data_ptr(),
            None if part is None else part.data_ptr(), m, k, n, _DTYPES[x.dtype], *tiling,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(rc, "matmul_stats")
    matmul_stats.launches += 1
    return y, s, ss


class MatmulStatsFunction(torch.autograd.Function):
    """``(y, sum, sumsq)`` under autograd. With cotangents ``gy``, ``gs``,
    ``gss`` the product's cotangent is ``G = gy + gs + 2*y*gss`` (f32), and
    ``dx = G @ w^T``, ``dw = x^T @ G``: the transpose of JAX's custom JVP."""

    @staticmethod
    def forward(ctx, x, w):
        wd = w.to(x.dtype)
        if x.device.type == "cpu":
            y, s, ss = matmul_stats_reference(x, wd)
        else:
            y, s, ss = _matmul_stats_cuda(x, wd.contiguous())
        ctx.save_for_backward(x, wd, y)
        ctx.w_dtype = w.dtype
        return y, s, ss

    @staticmethod
    def backward(ctx, gy, gs, gss):
        x, wd, y = ctx.saved_tensors
        g = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
        if gy is not None:
            g = g + gy.float()
        if gs is not None:
            g = g + gs.float()
        if gss is not None:
            g = g + 2.0 * y.float() * gss.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, wd.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.float().t(), g).to(ctx.w_dtype)
        return dx, dw


def matmul_stats(x: torch.Tensor, w: torch.Tensor):
    """One-pass ``y = x @ w`` plus per-column sum and sum of squares.

    ``x`` (M, K) in the compute dtype (f32 or bf16), ``w`` (K, N) in any
    float dtype (cast to ``x.dtype``). Returns ``(y (M, N) in x.dtype, sum
    (N,) f32, sumsq (N,) f32)``. On the CPU: the plain version. On CUDA: one
    kernel launch, counted in ``matmul_stats.launches``.
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_stats takes (M,K) @ (K,N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in _DTYPES or not w.is_floating_point():
        raise TypeError(f"matmul_stats computes in float32 or bfloat16, got {x.dtype}, {w.dtype}")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise ValueError(f"matmul_stats runs on one cpu or cuda device, got {x.device}, {w.device}")
    if x.device.type == "cuda":
        check_kernel_args(x, w)
    return MatmulStatsFunction.apply(x, w)


def check_kernel_args(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless the CUDA kernels take ``x`` (M, K) and ``w`` (K, N): x
    contiguous, sizes within 32-bit columns and 64-bit offsets, and for the
    bf16 kernel whole 16-byte chunks (K and N multiples of 8) and a 16-byte
    aligned x (the wrapper makes w contiguous). Reads only shapes, dtypes and
    addresses."""
    if not x.is_contiguous():
        raise ValueError("matmul_stats takes a contiguous (M, K) input")
    if max(x.shape[1], w.shape[1]) >= 2**31 or x.shape[0] * max(x.shape[1], w.shape[1]) >= 2**62:
        raise ValueError(f"matmul_stats input too large: {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype == torch.bfloat16 and (x.shape[1] % 8 or w.shape[1] % 8 or x.data_ptr() % 16):
        raise ValueError(f"the bf16 matmul_stats kernel takes K and N multiples of 8 and a 16-byte "
                         f"aligned x, got {tuple(x.shape)} @ {tuple(w.shape)}")


matmul_stats.launches = 0


def conv1x1_batch_stats(x: torch.Tensor, kernel: torch.Tensor):
    """(B, H, W, Cin) NHWC x (Cin, Cout) -> (y (B, H, W, Cout) in x.dtype,
    batch mean (Cout,) f32, biased batch variance (Cout,) f32). With more
    than one data rank the statistics are the global batch's
    (``parallel.mesh.global_moments``)."""
    b, h, w_, cin = x.shape
    cout = kernel.shape[-1]
    m = b * h * w_
    y, s, ss = matmul_stats(x.reshape(m, cin), kernel.reshape(cin, cout))
    if mesh.data_world() > 1:
        # the kernel's sums are this rank's rows: all-reduced over the global batch
        mean, var = mesh.global_moments(s, ss, m)
    else:
        mean = s / m
        var = torch.clamp_min(ss / m - mean * mean, 0.0)
    return y.reshape(b, h, w_, cout), mean, var
