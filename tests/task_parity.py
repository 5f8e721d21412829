"""Shared pieces of the parity tests of the reconstruction, projection and
joint tasks (``test_torch_reconstruct.py``, ``test_torch_project.py``,
``test_torch_joint.py``): synthetic clips made with numpy from a seed, the
JAX package's batch and configuration for them, JAX's noise draws, one JAX
train step with the JAX Trainer's optimizer, and the checks of a port step
and of checkpoint files against JAX's.

JAX's tasks draw their noise inside flax modules (``make_rng("latent")``)
and from the step's keys. ``with_normals`` jits a JAX function so that it
also returns every ``jax.random.normal`` draw it made, in the order it made
them; the tests hand those draws to the port (``eps``)."""

import contextlib
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax

from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
)
from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train.optim import adam_tf1
from acoustic_image_generation_tpu.train.state import TrainState as JaxTrainState
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt

LR = 1e-4


def raw_clips(seed, clips=2, frames=12, amplitude=2**15):
    """``clips`` clips of ``frames`` frames, actions 0, 1, 0, ... (every
    clip its own video), location 0."""
    rng = np.random.default_rng(seed)
    f = (clips, frames)
    return dict(
        acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
        audio=rng.integers(-amplitude, amplitude, (*f, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
        action=(np.arange(clips) % 2).astype(np.int32),
        location=np.zeros(clips, np.int32),
    )


def jax_batch(raw):
    """The JAX package's preprocessed ``Batch`` of ``raw``."""
    flat = {k: jnp.asarray(raw[k].reshape(-1, *raw[k].shape[2:])) for k in ("acoustic", "audio", "video")}
    rep = lambda a: jnp.repeat(jnp.asarray(a), raw["audio"].shape[1])
    return jax_preprocess(flat["acoustic"], flat["audio"], flat["video"], rep(raw["action"]),
                          rep(raw["location"]), compute_filtered=False)


def jax_cfg(lr=LR, **model):
    return ExperimentConfig(
        data=DataConfig(sample_length=1),
        model=ModelConfig(**model),
        optim=OptimConfig(learning_rate=lr),
        parallel=ParallelConfig(compute_dtype="float32"),
    )


def with_normals(fn):
    """``jax.jit(fn)``, returning ``(fn's outputs, [each jax.random.normal
    draw made while tracing fn, in order])``."""

    def wrapped(*args):
        draws = []
        normal = jax.random.normal

        def record(*a, **kw):
            out = normal(*a, **kw)
            draws.append(out)
            return out

        jax.random.normal = record
        try:
            out = fn(*args)
        finally:
            jax.random.normal = normal
        return out, draws

    jitted = jax.jit(wrapped)
    return lambda *args: jax.device_get(jitted(*args))


def jax_tx(task, lr=LR):
    """The JAX Trainer's optimizer for ``task``."""
    if hasattr(task, "param_labels"):
        return optax.multi_transform({"train": adam_tf1(lr), "frozen": optax.set_to_zero()}, task.param_labels)
    return adam_tf1(lr)


def jax_step(task, params, stats, batch, rngs, lr=LR):
    """One JAX train step as the Trainer's (``loss`` + ``value_and_grad`` +
    its optimizer): ``((state after it, loss, metrics), draws)``, the state a
    JAX ``TrainState`` of step 1."""
    tx = jax_tx(task, lr)

    def step(params, stats, batch):
        def loss_fn(p):
            total, metrics, new_stats = task.loss(p, stats, batch, rngs, train=True)
            return total, (metrics, new_stats)

        (loss, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        opt = tx.init(params)
        updates, opt = tx.update(grads, opt, params)
        state = JaxTrainState(step=jnp.int32(1), params=optax.apply_updates(params, updates),
                              batch_stats=new_stats, opt_state=opt)
        return state, loss, metrics

    return with_normals(step)(params, stats, batch)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# the leaves of the conv pairs of a module with train-mode BN: each BN divides
# by a fast-variance batch statistic, which magnifies rounding (see
# test_torch_embed_train.py), and the bias of a conv that BN follows has a
# true gradient of 0, so both sides hold rounding noise there
TRAIN_BN_LEAF = re.compile(r"/layer\d+/")


def check_step(task, init_params, want_params, lr=LR, noisy=None):
    """The port's parameters after one step against JAX's: each trained
    tensor's update (new - initial) entry by entry within 2 lr, 99% within
    lr/4 and within 10% in L2 (Adam turns a gradient at rounding-noise level
    into a full +-lr step of either sign), the leaves that ``noisy`` matches
    (``TRAIN_BN_LEAF`` of a module with train-mode BN) to the first bound
    alone, as ``test_torch_embed_train.py`` holds the BN VAEs; every
    frozen tensor bit-frozen. Returns the number of trained and frozen
    leaves."""
    got_p, _ = bridge.to_flax(task)
    init, want = dict(leaves(init_params)), dict(leaves(want_params))
    trained = {"/".join(path) for t, coll, path, _ in bridge.targets(task) if coll == "params" and t.requires_grad}
    counts = [0, 0]
    for key, value in leaves(got_p):
        if key not in trained:
            np.testing.assert_array_equal(value, init[key], err_msg=key)
            counts[1] += 1
            continue
        d_port, d_jax = value - init[key], np.asarray(want[key]) - init[key]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * lr, (key, float(gap.max() / lr))
        counts[0] += 1
        if noisy is not None and noisy.search(key):
            continue
        assert np.quantile(gap, 0.99) <= lr / 4, (key, float(np.quantile(gap, 0.99) / lr))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
    return counts


class PaddedLoader:
    """A loader of one batch of ``raw``'s clips whose clips after the first
    are padding (``valid`` 1)."""

    def __init__(self, raw):
        self.raw = raw

    def batches(self, epoch=0):
        yield dict(self.raw, valid=1)


@contextlib.contextmanager
def kept_buffers(module):
    """Put ``module``'s buffers (the BN running averages) back on exit."""
    saved = {n: b.clone() for n, b in module.named_buffers()}
    try:
        yield module
    finally:
        for n, b in module.named_buffers():
            b.copy_(saved[n])


def check_checkpoints_cross(trainer, state, jax_state, tmp_path):
    """Files both ways, byte for byte: the port's state, written by the
    port, restores in the JAX package into ``jax_state``'s template, and JAX
    writes the same bytes back; then JAX's state, written by the JAX
    package, restores into the port (parameters, statistics, Adam slots,
    step; in place of ``state``), and the port writes the same bytes back.
    The files (about 1 GB each for the tasks with the video VAE) are
    removed."""
    import flax.serialization as fs

    try:
        path = ckpt.save_checkpoint(str(tmp_path / "port"), 1, state)
        back = jckpt.restore_checkpoint(path, jax.device_get(jax_state))
        with open(path, "rb") as f:
            assert fs.to_bytes(jax.device_get(back)) == f.read()
        os.remove(path)
        jax_path = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jax_state)
        restored = trainer.restore(jax_path, trainer.init_state())
        assert restored.step == 1 and ckpt.slot_count(restored) == 1
        again = ckpt.save_checkpoint(str(tmp_path / "again"), 1, restored)
        with open(again, "rb") as f, open(jax_path, "rb") as g:
            assert f.read() == g.read()
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
