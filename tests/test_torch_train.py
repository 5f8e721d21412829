"""The port's generation train step against the JAX package, in f32 on the
CPU: losses, L2, TF1 Adam, train-mode BN, the parameter labels, the bridge
both ways and a 3-step trajectory.

Tolerances, and why:

- losses, L2 and train-mode BN: 1e-5 relative (the same f32 arithmetic,
  reduced in another order);
- TF1 Adam on the same gradients: one f32 rounding of the parameter per
  step;
- the trajectory: losses 1e-5 relative; the trunk bit-frozen on both
  sides. Each trained leaf's update (new - initial) is held to lr, since
  Adam normalizes every entry's step by its own gradient history: an entry
  whose gradient sits at rounding-noise level takes a full +-lr step in
  either framework, with the sign the noise gives it. So: every entry
  within 2*lr (one such step of opposite sign), 99% of each leaf's entries
  within lr/4, and the leaf's update within 10% in L2 norm (measured: 4%
  at worst, the conv_dec bias). The BN running statistics: within 1e-3 of
  how far the step moved them (measured 4e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acoustic_image_generation_tpu.core.config import ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.losses import recon as jrecon
from acoustic_image_generation_tpu.losses.regularization import l2_regularization as jax_l2
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.optim import adam_tf1, scale_by_tf1_adam
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.losses import recon
from acoustic_image_generation_tpu_torch.losses.regularization import l2_regularization
from acoustic_image_generation_tpu_torch.models.resnet import BatchNorm
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.optim import TF1Adam
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, step_generator

UNITS = (1, 1, 1, 1)
CLIPS, FRAMES = 1, 2
STEPS = 3
LR = 1e-4


def _np(t):
    return t.detach().numpy()


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    t = rng.random((4, 36, 48, 12)).astype(np.float32)
    p = rng.random((4, 36, 48, 12)).astype(np.float32) * 3 - 1  # |err| on both sides of delta
    logits = rng.standard_normal((4, 36, 48, 12)).astype(np.float32) * 30
    mean = rng.standard_normal((4, 150)).astype(np.float32)
    std = rng.random((4, 150)).astype(np.float32) + 0.01
    tt, tp = torch.from_numpy(t), torch.from_numpy(p)
    for got, want in (
        (recon.mse_tf(tt, tp), jrecon.mse_tf(t, p)),
        (recon.huber_tf(tt, tp), jrecon.huber_tf(t, p)),
        (recon.sigmoid_ce_logits(tt, torch.from_numpy(logits)), jrecon.sigmoid_ce_logits(t, logits)),
        (recon.kl_diag_gaussian(torch.from_numpy(mean), torch.from_numpy(std)),
         jrecon.kl_diag_gaussian(mean, std)),
    ):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=0)

    kernels = {"a": {"kernel": rng.standard_normal((3, 3, 4, 5)).astype(np.float32)},
               "b": {"conv": {"kernel": rng.standard_normal((1, 1, 5, 7)).astype(np.float32)},
                     "BatchNorm": {"scale": np.full((7,), 3.0, np.float32)}}}
    want = jax_l2(kernels, 5e-4)
    got = l2_regularization(
        [torch.from_numpy(kernels["a"]["kernel"]), torch.from_numpy(kernels["b"]["conv"]["kernel"])], 5e-4
    )
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    assert float(l2_regularization([torch.ones(3)], 0.0)) == 0.0


def test_tf1_adam_matches_optax_over_5_steps():
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [(rng.standard_normal((6, 5)) * 10.0 ** rng.integers(-6, 1)).astype(np.float32) for _ in range(5)]
    tx = adam_tf1(LR)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TF1Adam([pt], LR)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(_np(pt), np.asarray(pj), rtol=0, atol=np.spacing(np.abs(p0).max() + 1))
    # the moments are optax's too
    inner = state[0]
    np.testing.assert_allclose(_np(opt.state[pt]["m"]), np.asarray(inner.mu), rtol=1e-6)
    np.testing.assert_allclose(_np(opt.state[pt]["v"]), np.asarray(inner.nu), rtol=1e-6)
    assert opt.state[pt]["step"] == int(inner.count) == 5
    # the update is TF1's: eps on the uncorrected sqrt(v), not optax.adam's
    one = torch.nn.Parameter(torch.zeros(1))
    one.grad = torch.full((1,), 1e-8)
    TF1Adam([one], LR).step()
    ref = jnp.zeros(1) + scale_by_tf1_adam().update(jnp.full((1,), 1e-8), scale_by_tf1_adam().init(jnp.zeros(1)))[0] * -LR
    np.testing.assert_allclose(_np(one), np.asarray(ref), rtol=1e-6)


def test_train_mode_batch_norm_matches_flax():
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    scale = rng.random(6).astype(np.float32) + 0.5
    bias = rng.standard_normal(6).astype(np.float32)
    mean0 = rng.standard_normal(6).astype(np.float32)
    var0 = rng.random(6).astype(np.float32) + 0.5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.997, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def f(x, params):
        y, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut)

    (_, (y, mut)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables["params"]
    )

    port = BatchNorm(6, 1e-5)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = port(xt, train=True)
    (yt * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(yt), np.asarray(y), **tol)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), **tol)
    np.testing.assert_allclose(_np(port.weight.grad), np.asarray(gp["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(port.bias.grad), np.asarray(gp["bias"]), rtol=1e-4, atol=1e-4)
    # the biased batch variance goes into the running average, at 0.997
    np.testing.assert_allclose(_np(port.running_mean), np.asarray(mut["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(_np(port.running_var), np.asarray(mut["batch_stats"]["var"]), **tol)
    biased = x.reshape(-1, 6).var(0)
    np.testing.assert_allclose(_np(port.running_var), 0.997 * var0 + 0.003 * biased, rtol=1e-5)
    # eval mode leaves the running averages alone
    before = port.running_var.clone()
    port(xt, train=False)
    assert torch.equal(port.running_var, before)


def _jax_cfg():
    return ExperimentConfig(
        model=ModelConfig(resnet_units=UNITS), parallel=ParallelConfig(compute_dtype="float32")
    )


def _raw(seed):
    rng = np.random.default_rng(seed)
    return dict(
        acoustic=rng.random((CLIPS, FRAMES, 36, 48, 12)).astype(np.float32),
        audio=rng.integers(-(2**15), 2**15, (CLIPS, FRAMES, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (CLIPS, FRAMES, 224, 298, 3)).astype(np.uint8),
    )


def _jax_batch(raw):
    flat = {k: jnp.asarray(v.reshape(-1, *v.shape[2:])) for k, v in raw.items()}
    zeros = jnp.zeros((CLIPS * FRAMES,), jnp.int32)
    return jax_preprocess(flat["acoustic"], flat["audio"], flat["video"], zeros, zeros,
                          compute_filtered=False)


@functools.cache
def _jax_trajectory():
    """STEPS steps of the JAX train step (``GenerationTask.loss`` +
    ``value_and_grad`` + the Trainer's ``multi_transform``, one jit) from
    one init; returns the init, each step's loss, eps and batch seed, and
    the final trees."""
    task = JaxTask(_jax_cfg())
    tx = optax.multi_transform({"train": adam_tf1(LR), "frozen": optax.set_to_zero()},
                               task.param_labels)

    @jax.jit
    def step(params, stats, opt, batch, key):
        rngs = {"latent": key}
        out, _ = task._forward(params, stats, batch, rngs, train=True)

        def loss_fn(p):
            total, metrics, new_stats = task.loss(p, stats, batch, rngs, train=True)
            return total, (metrics, new_stats)

        (loss, (_, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, loss, (out.z - out.mean) / out.std

    params, stats = jax.jit(task.init_variables)(jax.random.key(0), _jax_batch(_raw(100)))
    init = jax.device_get((params, stats))
    opt = tx.init(params)
    losses, eps = [], []
    for s in range(STEPS):
        params, stats, opt, loss, e = step(params, stats, opt, _jax_batch(_raw(100 + s)), jax.random.key(10 + s))
        losses.append(float(loss))
        eps.append(np.asarray(e))
    return init, losses, eps, jax.device_get((params, stats)), task.param_labels(init[0])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_param_labels_cover_every_parameter_as_jax_does():
    init, *_, jax_labels = _jax_trajectory()
    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"), device="cpu")
    labels = task.param_labels()
    assert set(labels) == {n for n, _ in task.named_parameters()}
    by_path = {"/".join(path): label for path, label in _leaves(jax_labels)}
    # each port parameter has its JAX leaf's label
    for tensor, coll, path, _ in bridge.targets(task):
        if coll != "params":
            continue
        name = next(n for n, p in task.named_parameters() if p is tensor)
        top = next(by_path["/".join(path[:i])] for i in range(1, len(path) + 1)
                   if "/".join(path[:i]) in by_path)
        assert labels[name] == top, name
        assert tensor.requires_grad == (top == "train"), name
    assert labels["resnet.conv_map.weight"] == "train"
    assert labels["resnet.block1_unit_1.conv1.weight"] == "frozen"
    assert labels["resnet.conv_map.bn.weight"] == "train"


def test_bridge_round_trip_is_the_identity():
    init, *_ = _jax_trajectory()
    params, stats = init
    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="bfloat16"), device="cpu")
    bridge.load_flax(task, params, stats)
    # bf16 compute still holds f32 masters: the values land unrounded
    assert all(p.dtype == torch.float32 for p in task.parameters())
    back_p, back_s = bridge.to_flax(task)
    got = dict(_leaves(back_p)) | {("stats",) + k: v for k, v in _leaves(back_s)}
    want = dict(_leaves(params)) | {("stats",) + k: v for k, v in _leaves(stats)}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def test_step_generator_is_a_function_of_seed_and_step():
    a = torch.randn(4, generator=step_generator(0, 3, "cpu"))
    assert torch.equal(a, torch.randn(4, generator=step_generator(0, 3, "cpu")))
    assert not torch.equal(a, torch.randn(4, generator=step_generator(0, 4, "cpu")))
    assert not torch.equal(a, torch.randn(4, generator=step_generator(1, 3, "cpu")))


def test_three_step_trajectory_matches_jax():
    init, jax_losses, jax_eps, (jax_params, jax_stats), _ = _jax_trajectory()
    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"), device="cpu")
    bridge.load_flax(task, *init)
    trainer = Trainer(task)
    state = trainer.init_state()
    losses = []
    for s in range(STEPS):
        state, metrics = trainer.train_step(state, _raw(100 + s), eps=jax_eps[s])
        losses.append(float(metrics["loss"]))
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)

    got_p, got_s = bridge.to_flax(task)
    labels = task.param_labels()
    name_of = {id(t): n for n, t in task.named_parameters()}
    paths = {"/".join(path): name_of.get(id(t)) for t, _, path, _ in bridge.targets(task)}
    init_p = dict(_leaves(init[0]))
    want_p = dict(_leaves(jax_params))
    for path, value in _leaves(got_p):
        key = "/".join(path)
        if labels[paths[key]] == "frozen":
            np.testing.assert_array_equal(value, init_p[path], err_msg=key)
            np.testing.assert_array_equal(want_p[path], init_p[path], err_msg=key)
            continue
        d_port = value - init_p[path]
        d_jax = want_p[path] - init_p[path]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
        # every trained leaf moved, layer2 (on conv_chain here) included
        assert np.abs(d_jax).max() > 0.5 * LR and np.abs(d_port).max() > 0.5 * LR, key
    init_s = dict(_leaves(init[1]))
    want_s = dict(_leaves(jax_stats))
    for path, value in _leaves(got_s):
        moved = np.abs(want_s[path] - init_s[path]).max()
        assert np.abs(value - want_s[path]).max() <= 1e-3 * moved, "/".join(path)
    # the trunk's running statistics moved (trunk_bn="train")
    moved = got_s["resnet"]["block1_unit_1"]["conv1"]["BatchNorm"]["mean"]
    assert not np.array_equal(moved, init[1]["resnet"]["block1_unit_1"]["conv1"]["BatchNorm"]["mean"])


def test_train_forward_needs_noise_and_trunk_bn_frozen_keeps_statistics():
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen")
    task = GenerationTask(cfg, device="cpu").init_params(0)
    batch = Trainer(task)._prepare(_raw(5))
    with pytest.raises(ValueError, match="samples the VAE noise"):
        task.loss(batch)
    trunk = task.resnet.block1_unit_1.conv1.bn.running_mean.clone()
    head = task.resnet.conv_map.bn.running_mean.clone()
    task.loss(batch, generator=torch.Generator().manual_seed(0))
    assert torch.equal(task.resnet.block1_unit_1.conv1.bn.running_mean, trunk)
    assert not torch.equal(task.resnet.conv_map.bn.running_mean, head)
    with pytest.raises(ValueError, match="trunk_bn"):
        GenerationTask(GenerationConfig(resnet_units=UNITS, trunk_bn="fixed"), device="cpu")
