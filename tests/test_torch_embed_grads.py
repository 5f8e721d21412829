"""The first embedding train step's gradients against JAX run eagerly, in
f32 on the CPU: ``Trainer.train_step`` on an ``EmbedTask`` (full width, 3
seconds, the default batch-hard triplet variant, the first step of
``test_torch_embed_train.py``) against ``jax.grad`` of JAX's
``EmbedTask.loss`` under ``jax.disable_jit()``, with JAX's noise handed in.
Eager JAX runs each primitive alone, as the port does, so no compiler
fuses or reorders its sums.

Tolerances, and why: the gradients in L2 relative to JAX's, per leaf and
per VAE. The acoustic VAE (no BN) leaf by leaf within 1e-4 (read 7.9e-6).
The audio and video VAEs' train-mode BNs divide by fast-variance batch
statistics of 3 samples, which magnify the rounding gaps of two correct
f32 programs; read with 1, 3 and 8 torch threads: audio up to 6.0e-2 on a
leaf (``layer1.bn_1``'s bias) and 2.4e-2 over the VAE, video up to 1.5e-2
on a leaf and 1.3e-3 over the VAE. So audio leaves within 0.12 and the
audio VAE within 4e-2, video leaves within 3e-2 and the video VAE within
3e-3. A wrong sign or a missing term on a leaf reads 1 or more. The biases
of the convs that a train-mode BN follows are left out: their true
gradient is zero and both sides hold rounding noise.
"""

import jax
import numpy as np

from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from test_torch_embed import draws, jax_batch, jax_cfg, jax_init, port_task, raw_clips
from test_torch_embed_train import AMP, LR, JaxEmbed, _bn_cancelled, _leaves, _port_grads
from torch_threads import few_torch_threads  # noqa: F401

LEAF_TOL = dict(acoustic=1e-4, audio=0.12, video=3e-2)
VAE_TOL = dict(audio=4e-2, video=3e-3)


def test_first_step_gradients_match_eager_jax():
    key = jax.random.key(20)
    raw = raw_clips(10, amplitude=AMP)
    params, stats = jax_init()
    jt = JaxEmbed(jax_cfg(lr=LR))
    batch = jax_batch(raw)

    def loss_fn(p):
        return jt.loss(p, stats, batch, {"latent": key, "moddrop": key}, train=True)[0]

    with jax.disable_jit():
        want = _leaves(jax.device_get(jax.grad(loss_fn)(params)))

    task = port_task(lr=LR)
    trainer = Trainer(task)
    eps, _ = draws(key)
    trainer.train_step(trainer.init_state(), raw, eps=eps)
    got = _port_grads(task)
    assert got.keys() == want.keys()

    sums = {m: [0.0, 0.0] for m in VAE_TOL}
    for k, g in got.items():
        if _bn_cancelled(k):
            continue
        model = k.split("'")[1]
        gap = np.linalg.norm(g - want[k]) / np.linalg.norm(want[k])
        assert gap <= LEAF_TOL[model], (k, float(gap))
        if model in sums:
            sums[model][0] += np.sum((g - want[k]) ** 2)
            sums[model][1] += np.sum(want[k] ** 2)
    for model, (gap, norm) in sums.items():
        assert np.sqrt(gap / norm) <= VAE_TOL[model], (model, float(np.sqrt(gap / norm)))
