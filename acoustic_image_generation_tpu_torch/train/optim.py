"""Adam, as TF1 and as optax compute it.

Counterpart of ``acoustic_image_generation_tpu/train/optim.py`` (``TF1Adam``)
and of ``optax.adam`` (``Adam``), which JAX's trainer runs with
``optim.tf1_adam=False``. ``tf.compat.v1.train.AdamOptimizer`` applies

    alpha = sqrt(1 - b2^t) / (1 - b1^t)
    theta -= lr * alpha * m_t / (sqrt(v_t) + eps)

with eps added to the *uncorrected* sqrt(v_t), and alpha computed in f32
(TF1's ``beta_power`` variables, JAX's f32 step count). ``optax.adam``
divides each moment by its own bias correction, ``m_hat = m_t / (1 -
b1^t)`` and ``v_hat = v_t / (1 - b2^t)`` (f32), adds eps to
``sqrt(v_hat)`` and scales by ``-lr`` last. ``torch.optim.Adam`` orders
these operations differently again, so the port has its own two. Only the
parameters given to them get slots and updates: frozen parameters are left
out, the counterpart of ``optax.set_to_zero()`` under ``multi_transform``.
Both keep ``step``, ``m`` and ``v`` per tensor: the checkpoint's ``count``,
``mu`` and ``nu``, in the same chain layout (``{"0": adam, "1": {}}``).
Under FSDP a parameter is a shard (``parallel/mesh.py``): the update runs
on its local tensor and its ``m`` and ``v`` are the same rows, with the
same arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.parallel import mesh


class _Adam(torch.optim.Optimizer):
    """The slots and the loop shared by the two; ``_update`` is the rule."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                # an FSDP shard is updated through its local tensor, its slots the same shard's
                w = mesh.local(p)
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(w, memory_format=torch.preserve_format)
                    state["v"] = torch.zeros_like(w, memory_format=torch.preserve_format)
                state["step"] += 1
                self._update(w, mesh.local(p.grad), state, group)

    def _update(self, p, g, state, group) -> None:
        raise NotImplementedError


class TF1Adam(_Adam):
    def _update(self, p, g, state, group) -> None:
        lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
        m, v, t = state["m"], state["v"], state["step"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        t32, one = np.float32(t), np.float32(1.0)
        alpha = float(np.sqrt(one - np.float32(b2) ** t32) / (one - np.float32(b1) ** t32))
        p.add_(m * alpha / (v.sqrt() + eps), alpha=-lr)


def _integer_pow(b: float, t: int) -> np.float32:
    """``b ** t`` in f32 by binary exponentiation, each product rounded:
    ``lax.integer_pow``, which JAX's ``decay ** count`` runs on a concrete
    count."""
    x, acc = np.float32(b), None
    while t > 0:
        if t & 1:
            acc = x if acc is None else np.float32(acc * x)
        t >>= 1
        if t > 0:
            x = np.float32(x * x)
    return acc


class Adam(_Adam):
    """``optax.adam(lr)`` (``eps_root=0``), each operation rounded on its own
    as optax's operations are when JAX runs them one by one: ``m = (1 - b1)
    g + b1 m``, ``v = (1 - b2) g^2 + b2 v``, the corrections ``1 - b^t`` in
    f32 (``_integer_pow``), each moment divided by its correction on the
    device, the square root correctly rounded, then ``-lr`` times the
    quotient added to the parameter. CUDA's f32 ``sqrt`` is correctly
    rounded; torch's vectorized f32 ``sqrt`` on the CPU is not (about 1 in
    150 roots is an ulp off), so there the root is taken in float64 and
    rounded back, which gives the correctly rounded f32 root. No operation takes an ``alpha``, which
    the CPU kernels may fuse into an FMA. Under ``jit`` XLA computes ``b^t``
    with ``pow`` on the traced count and contracts the updates into FMAs: a
    few ulps away (``tests/test_torch_optim.py``)."""

    def _update(self, p, g, state, group) -> None:
        lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
        m, v, t = state["m"], state["v"], state["step"]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * g * (1 - b2))
        # 0-dim device tensors: a CUDA division by a host scalar multiplies by its reciprocal
        c1, c2 = (torch.full((), float(np.float32(1) - _integer_pow(b, t)), dtype=m.dtype, device=m.device)
                  for b in (b1, b2))
        v_hat = v / c2
        root = v_hat.sqrt() if v_hat.is_cuda else v_hat.double().sqrt().to(v.dtype)
        p.add_((m / c1) / (root + eps) * -lr)
