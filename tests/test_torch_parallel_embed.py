"""The embedding family on two ranks (``parallel/mesh.py``: one process a
device, gloo on the CPU) against JAX's one program over a two-device CPU
mesh, in f32 at full width: one step of a 4-second global batch (2 seconds
a rank) whose labels 0, 1, 1, 0 put each label on both ranks, so that the
batch-hard mining and the all-triplet and NCA terms pair rows across them.

One spawn of two ranks (``tests/parallel_task_ranks.py``) runs every port
case while JAX compiles in this process: a step of each variant (default
triplet, ``fusion``, ``moddrop``, ``proxy``, ``l2``) under DDP, the default
under FSDP, ``evaluate`` over a remainder batch, the VAEs' BN layer and
``mesh.all_gather_rows`` alone. The same weights (the port's
``init_params(0)``, biases, BN parameters and statistics drawn away from
their initial values) and the same noise (a numpy ``eps``, and moddrop
uniforms that drop the audio) go into both. JAX's side is one jitted
program on its ``Trainer``'s mesh (its ``device_batch`` shards the global
batch, its ``_prepare`` and step keys make the batch) that returns each
variant's loss, metrics and new BN statistics, the default variant's
gradient of every trained tensor and the others' of the acoustic VAE; its
TF1 Adam (``adam_tf1``, the Trainer's optimizer) takes the step.

Tolerances (those of ``tests/test_torch_embed_train.py``, and why):

- loss terms within 1e-4 relative: the reconstruction terms pass through
  the decoders' train-mode BNs, whose fast-variance cancellation magnifies
  rounding; the BN running averages within 1e-3, and moved;
- the acoustic VAE (no BN): its gradient (Adam's first moment over 0.1)
  within 1e-2 of JAX's in L2, leaf by leaf (one process reads the same
  gaps on this batch: 7.4e-4 on the decoder's dense layer, 3.7e-3 on the
  mean head's bias under NCA, whose min-max normalization routes the
  gradient through single entries), and its update within 2 lr entry by
  entry, 99% within lr/4 and within 10% in L2; a gradient twice or half the
  global term's would show in the first, not in the update (Adam's first
  step is lr times the gradient's sign, so opposite signs sit at 2 lr, plus
  rounding: ``parallel_task_ranks.update_bound``);
- the audio and video VAEs (the default variant): each update within 2 lr;
  the gradient within 0.5 of JAX's in L2 a leaf and 5e-2 over each VAE's
  leaves together (JAX against itself differs by up to 3e-2 on a leaf),
  the biases that a train-mode BN follows left out (true gradient zero);
- the two ranks against each other: bit for bit (the same averaged
  gradients, the same global statistics and gathered latents);
- FSDP against DDP: the losses within 1e-5 relative, the first moments
  within 1e-5 in L2 a VAE, the acoustic VAE's update by the criteria above;
- ``evaluate`` against one process: 1e-5 relative (the same f32 arithmetic
  in another order); the BN layer and the gather against JAX's and one
  process's autograd: 1e-5 of each tensor's largest entry.
"""

import concurrent.futures as cf
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import parallel_task_ranks as ptr
from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.models.layers import batch_norm as jax_batch_norm
from acoustic_image_generation_tpu.parallel import batch_sharding, fsdp_sharding, make_mesh
from acoustic_image_generation_tpu.train.embed import EmbedTask as JaxEmbed
from acoustic_image_generation_tpu.train.optim import adam_tf1
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
SECONDS = 4
ACTIONS = np.array([0, 1, 1, 0], np.int32)  # rank 0 holds 0, 1; rank 1 holds 1, 0
AMP = 4  # low-amplitude audio, as tests/test_torch_embed_train.py's
MODDROP_UNIFORMS = (0.5, 0.99, 0.25)  # keep video (< .98), drop audio, keep acoustic (< .5)
VAES = ("acoustic", "audio", "video")


def raw_clips(seed):
    rng = np.random.default_rng(seed)
    f = (SECONDS, 12)
    return dict(acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
                audio=rng.integers(-AMP, AMP, (*f, 1024)).astype(np.int32),
                video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
                action=ACTIONS, location=np.zeros(SECONDS, np.int32))


def jax_cfg(variant):
    flags = {v: v == variant for v in ("fusion", "moddrop", "l2", "proxy")}
    return ExperimentConfig(data=DataConfig(batch_size=SECONDS, sample_length=1),
                            model=ModelConfig(embedding=True, **flags), optim=OptimConfig(learning_rate=LR),
                            run=RunConfig(checkpoint_dir="unused"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=2))


@contextlib.contextmanager
def jax_draws(eps):
    """JAX's latent noise is ``eps`` and its moddrop uniforms
    ``MODDROP_UNIFORMS`` (constants of the traced program)."""
    normal, uniform = jax.random.normal, jax.random.uniform
    uniforms = iter(MODDROP_UNIFORMS * 2)

    def fixed_normal(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return jnp.asarray(eps, dtype)

    def fixed_uniform(key, shape=(), dtype=jnp.float32, *args, **kw):
        assert tuple(shape) == (1,), shape
        return jnp.full(shape, next(uniforms), dtype)

    jax.random.normal, jax.random.uniform = fixed_normal, fixed_uniform
    try:
        yield
    finally:
        jax.random.normal, jax.random.uniform = normal, uniform


def jax_step(init, raw, eps):
    """JAX's program on its Trainer's two-device mesh: ``{variant:
    (metrics, new batch_stats, gradient)}``, the gradient of every trained
    tensor for the default variant, of the acoustic VAE for the others."""
    trainers = {v: JaxTrainer(JaxEmbed(jax_cfg(v)), jax_cfg(v)) for v in ptr.VARIANTS}
    jtr = trainers["triplet"]

    def program(params, stats, device_raw):
        rngs = jrng.train_step_rngs(jtr.base_key, 0)
        batch = jtr._prepare(device_raw, key=rngs["data"])
        out = {}
        for variant, trainer in trainers.items():
            def loss(p, variant=variant):
                whole = p if variant == "triplet" else dict(params, acoustic=p)
                total, metrics, new_stats = trainers[variant].task.loss(whole, stats, batch, rngs, train=True)
                return total, (metrics, new_stats)

            wrt = params if variant == "triplet" else params["acoustic"]
            (_, (metrics, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(wrt)
            out[variant] = (metrics, new_stats, grads)
        return out

    params, stats = (jax.device_put(t, jtr._replicated) for t in init)
    device_raw = jtr.device_batch(JaxRawBatch(raw["acoustic"], raw["audio"], raw["video"], raw["action"],
                                              raw["location"], SECONDS))
    with jax_draws(eps):
        return jax.device_get(jax.jit(program)(params, stats, device_raw))


def adam_step(params: dict, grads: dict) -> dict:
    """The parameters after one step of JAX's Trainer's optimizer (TF1
    Adam) from ``grads``."""
    tx = adam_tf1(LR)

    @jax.jit
    def step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    return jax.device_get(step(params, grads))


def jax_bn(spec):
    """The VAEs' BN (``ref/models/layers.py::batch_norm``) in train mode on
    the global rows, sharded over a two-device mesh: ``y``, the gradients
    of ``sum(y * w)`` and the new running averages."""
    bn = jax_batch_norm(train=True)
    x = spec["bn_x"]
    variables = bn.init(jax.random.key(0), x)
    params = {"scale": jnp.asarray(spec["bn_scale"]), "bias": jnp.asarray(spec["bn_bias"])}

    def loss(x, params):
        y, new = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, mutable=["batch_stats"])
        return jnp.sum(y * spec["bn_w"]), (y, new["batch_stats"])

    sharded = jax.device_put(x, batch_sharding(make_mesh(2)))
    (_, (y, stats)), (dx, dp) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(sharded, params)
    return jax.device_get(dict(y=y, dx=dx, dscale=dp["scale"], dbias=dp["bias"], mean=stats["mean"],
                               var=stats["var"]))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def tree_of(leaves: dict, prefix: str) -> dict:
    """The nested tree of ``leaves`` (flax paths) under ``prefix``."""
    out = {}
    for key, value in leaves.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = out
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the spawn of two ranks (in a thread), JAX's program and
    the one-process evaluation."""
    with module_dir(tmp_path_factory, "parallel_embed", need_mb=1000) as tmp:  # the ranks' pickled results
        params, stats = bridge.to_flax(EmbedTask(EmbedConfig(compute_dtype="float32"), device="cpu").init_params(0))
        init = (perturb(params, np.random.default_rng(1)), perturb(stats, np.random.default_rng(2)))
        lists = write_synthetic_dataset(str(tmp / "ds"), num_classes=1, videos_per_class=1, seconds_per_video=3,
                                        seed=4)
        rng = np.random.default_rng(5)
        eps = rng.standard_normal((SECONDS, 128)).astype(np.float32)
        moddrop = tuple(float(u < p) for u, p in zip(MODDROP_UNIFORMS, (0.98, 0.98, 0.5)))
        spec = dict(init=init, raws=[raw_clips(10)], eps=[eps], moddrop=moddrop, valid_list=lists["validation"],
                    bn_x=rng.standard_normal((4, 6, 5, 8)).astype(np.float32),
                    bn_w=rng.standard_normal((4, 6, 5, 8)).astype(np.float32),
                    bn_scale=(0.5 + rng.random(8)).astype(np.float32),
                    bn_bias=rng.standard_normal(8).astype(np.float32),
                    gather_x=rng.standard_normal((4, 3)).astype(np.float32))
        with cf.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(mesh.launch, ptr.embed_cases, 2, spec, device="cpu", tmp_dir=str(tmp))
            jax_out = jax_step(init, spec["raws"][0], eps)
            bn = jax_bn(spec)
            specs = dict(flat(jax.tree_util.tree_map(lambda s: tuple(s.spec), fsdp_sharding(init[0], make_mesh(2)))))
            # one process's evaluate over the same split
            trainer = Trainer(ptr.embed_task("triplet", init))
            one = trainer.evaluate(trainer.init_state(), AcousticImageDataLoader(lists["validation"], "validation", 2),
                                   use_cache=False)
            out = ranks.result()
        yield dict(spec=spec, init=init, ranks=out, jax=jax_out, bn=bn, jax_specs=specs, one_eval=one)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"^(audio|video)/layer\d+/(conv|pool)_\d/bias$", key))


def check_update(key, got, want, init, tight: bool):
    """A leaf's update against JAX's: every entry within 2 lr; with
    ``tight`` also 99% within lr/4 and 10% in L2."""
    d_got, d_want = got - init, want - init
    gap = np.abs(d_got - d_want)
    assert np.all(gap <= ptr.update_bound(1, init)), (key, float(gap.max() / LR))
    if tight:
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_want), key


def test_the_global_batch_puts_each_label_on_both_ranks(world):
    halves = [set(mesh.shard_rows(ACTIONS, r, 2)) for r in (0, 1)]
    assert halves[0] == halves[1] == {0, 1}
    assert world["spec"]["moddrop"] == (1.0, 0.0, 1.0)


@pytest.mark.parametrize("variant", ptr.VARIANTS)
def test_ddp_step_matches_jax_mesh(world, variant):
    got = world["ranks"][0][variant]
    metrics, new_stats, grads = world["jax"][variant]
    (step,) = got["metrics"]
    assert step.keys() == metrics.keys()
    for name, value in step.items():
        np.testing.assert_allclose(value, float(metrics[name]), rtol=1e-4, err_msg=name)
    init_stats = dict(flat(world["init"][1]))
    for key, value in dict(flat(new_stats)).items():
        np.testing.assert_allclose(got["stats"][key], value, rtol=1e-3, atol=1e-3, err_msg=key)
        assert not np.array_equal(got["stats"][key], init_stats[key]), key  # the audio and video BNs moved
    # the acoustic VAE: its gradient and its update
    ac_grads = dict(flat(grads if variant != "triplet" else grads["acoustic"]))
    init_ac = world["init"][0]["acoustic"]
    ac_new = dict(flat(adam_step(init_ac, tree_of({"acoustic/" + k: v for k, v in ac_grads.items()}, "acoustic"))))
    init_flat = dict(flat(init_ac))
    for key, g in ac_grads.items():
        gap = l2(got["mu"]["acoustic/" + key] / 0.1, g)
        assert gap <= 1e-2, (key, gap)
        check_update(key, got["params"]["acoustic/" + key], ac_new[key], init_flat[key], tight=True)


def test_triplet_gradient_of_every_vae_is_the_global_batchs(world):
    """The default variant's whole gradient and step on two ranks against
    JAX's on the global batch: the gathered latents' gradient reaches the
    audio and video encoders too, and the BN statistics' gradients cover
    both ranks' rows."""
    got = world["ranks"][0]["triplet"]
    _, _, grads = world["jax"]["triplet"]
    want = {k: v for k, v in flat(grads)}
    new = dict(flat(adam_step(world["init"][0], grads)))
    init = dict(flat(world["init"][0]))
    sums = {m: [0.0, 0.0] for m in ("audio", "video")}
    for key, g in want.items():
        g = ptr.sampled(g)  # the rank samples its largest leaves (the video VAE's head)
        check_update(key, got["params"][key], ptr.sampled(new[key]), ptr.sampled(init[key]),
                     tight=key.startswith("acoustic/"))
        if _bn_cancelled(key) or key.startswith("acoustic/"):
            continue
        mine = got["mu"][key] / 0.1
        assert l2(mine, g) <= 0.5, (key, l2(mine, g))
        sums[key.split("/")[0]][0] += float(np.sum((mine.astype(np.float64) - g) ** 2))
        sums[key.split("/")[0]][1] += float(np.sum(np.asarray(g, np.float64) ** 2))
    for model, (num, den) in sums.items():
        assert np.sqrt(num / den) <= 5e-2, (model, float(np.sqrt(num / den)))


@pytest.mark.parametrize("case", [*ptr.VARIANTS, "fsdp"])
def test_ranks_hold_the_same_state_and_metrics(world, case):
    a, b = (world["ranks"][r][case] for r in (0, 1))
    assert a["digest"] == b["digest"] and a["metrics"] == b["metrics"]
    for key in a["stats"]:
        np.testing.assert_array_equal(a["stats"][key], b["stats"][key], err_msg=key)


def test_fsdp_step_matches_ddp_and_shards_as_jax(world):
    ddp, fsdp = world["ranks"][0]["triplet"], world["ranks"][0]["fsdp"]
    for name, value in fsdp["metrics"][0].items():
        np.testing.assert_allclose(value, ddp["metrics"][0][name], rtol=1e-5, err_msg=name)
    assert all(gap <= 1e-5 for gap in fsdp["mu_gap"].values()), fsdp["mu_gap"]
    init = dict(flat(world["init"][0]))
    for key, value in fsdp["params"].items():
        if key.startswith("acoustic/"):
            check_update(key, value, ddp["params"][key], init[key], tight=True)
    # the leaves JAX's fsdp_sharding shards are the ones FSDP shards, and the Adam moments with them
    task = EmbedTask(EmbedConfig(compute_dtype="float32"), device="cpu")
    name_of = {id(p): n for n, p in task.named_parameters()}
    want = sorted(name_of[id(t)] for t, coll, path, _ in bridge.targets(task)
                  if coll == "params" and any(a is not None for a in world["jax_specs"]["/".join(path)]))
    assert fsdp["sharded"] == want and len(want) >= 6
    assert ddp["sharded"] == [] and fsdp["moments"] < 0.7 * ddp["moments"]


def test_evaluate_with_a_remainder_batch_matches_one_process(world):
    assert [world["ranks"][r]["eval"]["valid"] for r in (0, 1)] == [[1, 1], [1, 0]]
    want = world["one_eval"]
    for r in (0, 1):
        got = world["ranks"][r]["eval"]["means"]
        assert got.keys() == want.keys() == {"mse", "mse_acoustic", "mse_audio", "mse_video"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=(r, k))


def test_train_mode_bn_with_gradients_matches_jax_mesh(world):
    """The VAEs' BN on two ranks, forward and backward, against JAX's over
    a two-device mesh: each rank's rows of ``y`` and of ``x``'s gradient,
    the sum over the ranks of the scale's and bias's gradients (DDP's
    average of them, times two), and the same running averages on both."""
    want = world["bn"]
    got = [world["ranks"][r]["bn"] for r in (0, 1)]
    for key in ("y", "dx"):
        assert rel(np.concatenate([g[key] for g in got]), want[key]) <= 1e-5, key
    for key in ("dscale", "dbias"):
        assert rel(got[0][key] + got[1][key], want[key]) <= 1e-5, key
    for key in ("mean", "var"):
        for g in got:
            assert rel(g[key], want[key]) <= 1e-5, key


def test_gather_sums_the_ranks_gradients(world):
    """``all_gather_rows``: the global rows in rank order, and each rank's
    gradient the sum over the ranks of the gradient of the term each
    computes, cut to its rows (the term's gradient, twice: DDP's average
    brings it back), against one process's autograd on the global rows."""
    x = torch.from_numpy(world["spec"]["gather_x"]).requires_grad_(True)
    term = torch.sum((x @ x.T) ** 2)
    term.backward()
    got = [world["ranks"][r]["gather"] for r in (0, 1)]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["gathered"], x.detach().numpy())
        np.testing.assert_array_equal(g["labels"], [0, 1, 100, 101])
        assert rel(g["term"], term.item()) <= 1e-6
        assert rel(g["dx"], 2 * mesh.shard_rows(x.grad.numpy(), r, 2)) <= 1e-5
