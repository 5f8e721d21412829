"""TF1-exact Adam.

Counterpart of ``acoustic_image_generation_tpu/train/optim.py``.
``tf.compat.v1.train.AdamOptimizer`` applies

    alpha = sqrt(1 - b2^t) / (1 - b1^t)
    theta -= lr * alpha * m_t / (sqrt(v_t) + eps)

with eps added to the *uncorrected* sqrt(v_t), and alpha computed in f32
(TF1's ``beta_power`` variables, JAX's f32 step count). ``torch.optim.Adam`` adds
it to the bias-corrected sqrt(v_hat), a different step in the first
iterations, so the port has its own optimizer. Only the parameters given to
it get slots and updates: frozen parameters are left out, the counterpart
of ``optax.set_to_zero()`` under ``multi_transform``.
"""

from __future__ import annotations

import numpy as np
import torch


class TF1Adam(torch.optim.Optimizer):
    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TF1Adam takes no closure")
        for group in self.param_groups:
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["v"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                g = p.grad
                m, v = state["m"], state["v"]
                state["step"] += 1
                t = state["step"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                t32, one = np.float32(t), np.float32(1.0)
                alpha = float(np.sqrt(one - np.float32(b2) ** t32) / (one - np.float32(b1) ** t32))
                p.add_(m * alpha / (v.sqrt() + eps), alpha=-lr)
