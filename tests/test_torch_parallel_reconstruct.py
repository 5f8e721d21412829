"""The reconstruction task on two ranks (``parallel/mesh.py``: one process
a device, gloo on the CPU) against JAX's ``Trainer`` on a two-device CPU
mesh (one program over the global batch), in f32 at full width, for each
``encoder_type``: ``Ac`` and ``Energy`` on 2 clips of 2 frames, ``Audio`` on
2 one-second clips (each its 99x257 spectrogram), ``Video`` on 2 clips of
one frame; a clip a rank. ``Ac`` and ``Energy`` train two steps under DDP,
``Audio`` two under FSDP and ``Video`` one under FSDP (its 845 MB of
parameters leave each rank half the Adam moments). The ``Audio`` run
writes its final state, FSDP's shards gathered whole, which one process
restores.

One spawn of two ranks (``tests/parallel_task_ranks.py``) runs every port
case while JAX compiles in this process. The same weights (the port's
``init_params(0)``, biases, BN parameters and statistics drawn away from
their initial values) and the same noise (a numpy draw at the global
shape, handed to the port as ``eps`` and to JAX in place of its
``jax.random.normal``, the same each step) go into both.

Tolerances (``tests/test_torch_parallel.py``'s and
``task_parity.check_step``'s, and why): the losses within 1e-4 relative
(through the audio and video VAEs' train-mode BNs, whose fast-variance
cancellation magnifies rounding); each trained tensor's update within 2 lr
a step entry by entry (``parallel_task_ranks.update_bound``: twice the
largest step TF1's Adam can take, which turns a gradient at rounding level
into a +-lr step of either sign, plus rounding); for the VAEs
without BN (``Ac``, ``Energy``) also 99% within lr/4 and 10% in L2, as
``tests/test_torch_embed_train.py`` holds the acoustic VAE and its audio
and video VAEs to the first bound alone; the BN running averages within
1e-3 of how far they moved; Adam's first moments (the gradients, which
the updates cannot show: Adam's step is blind to a gradient's scale), in
L2, within 0.5 of JAX's a leaf and 5e-2 over the VAE for the BN VAEs, the
biases that a train-mode BN follows left out (true gradient zero), as
``tests/test_torch_parallel_embed.py`` holds the audio and video VAEs
(read: 1.6e-3 over ``Audio``, 9.6e-3 over ``Video``), and within 5e-2 a
leaf and 1e-3 over the VAE for ``Ac`` and ``Energy`` (read: 1.8e-2 on
``Ac``'s dense kernel after its two steps, 2.9e-4 over it); a gradient N
times too large or too small reads |1 - N| or |1 - 1/N| there; the two
ranks against each other and the checkpoint restored at one process bit
for bit. The two largest leaves of the video
VAE (its head's 1024-channel convs, 100M entries each) are held on every
stride-th entry (``parallel_task_ranks.sampled``).
"""

import concurrent.futures as cf
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from optax import ScaleByAdamState

import parallel_task_ranks as ptr
from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.parallel import fsdp_sharding, make_mesh
from acoustic_image_generation_tpu.train.reconstruct import ReconstructTask as JaxReconstruct
from acoustic_image_generation_tpu.train.state import TrainState as JaxTrainState
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.reconstruct import LATENTS, ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from task_parity import raw_clips
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
KINDS = {  # clips, frames, steps, FSDP
    "Ac": (2, 2, 2, False),
    "Energy": (2, 2, 2, False),
    "Audio": (2, 12, 2, True),
    "Video": (2, 1, 1, True),
}


def samples(kind) -> int:
    clips, frames, _, _ = KINDS[kind]
    return clips if kind == "Audio" else clips * frames


def jax_cfg(kind):
    clips = KINDS[kind][0]
    return ExperimentConfig(data=DataConfig(batch_size=clips, sample_length=1),
                            model=ModelConfig(model="UNet", encoder_type=kind), optim=OptimConfig(learning_rate=LR),
                            run=RunConfig(checkpoint_dir="unused"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=2))


@contextlib.contextmanager
def jax_noise(eps):
    """JAX's VAE draws ``eps`` (a constant of the traced program)."""
    normal = jax.random.normal

    def fixed(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return jnp.asarray(eps, dtype)

    jax.random.normal = fixed
    try:
        yield
    finally:
        jax.random.normal = normal


def jax_run(kind, case):
    """JAX's Trainer on its two-device mesh: each step's loss, the final
    parameters and BN statistics, and its Adam's first moments."""
    jtr = JaxTrainer(JaxReconstruct(jax_cfg(kind)), jax_cfg(kind))
    params, stats = case["init"]
    state = jax.device_put(JaxTrainState(step=jnp.int32(0), params=params, batch_stats=stats,
                                         opt_state=jtr.tx.init(params)), jtr._replicated)
    losses = []
    with jax_noise(case["eps"][0]):
        for raw in case["raws"]:
            clips = raw["audio"].shape[0]
            state, metrics = jtr.train_step(state, JaxRawBatch(raw["acoustic"], raw["audio"], raw["video"],
                                                               raw["action"], raw["location"], clips))
            losses.append(jax.device_get(metrics))
    (adam,) = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda s: isinstance(s, ScaleByAdamState))
               if isinstance(s, ScaleByAdamState)]
    return dict(metrics=losses, final=jax.device_get((state.params, state.batch_stats)), mu=jax.device_get(adam.mu))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the spawn of two ranks (in a thread) and JAX's runs."""
    with module_dir(tmp_path_factory, "parallel_reconstruct", need_mb=400) as tmp:  # the ranks' results, a checkpoint
        cases = {}
        for i, (kind, (clips, frames, steps, fsdp)) in enumerate(KINDS.items()):
            task = ReconstructTask(ReconstructConfig(encoder_type=kind, compute_dtype="float32"), device="cpu")
            params, stats = bridge.to_flax(task.init_params(i))
            del task
            eps = np.random.default_rng(10 + i).standard_normal((samples(kind), LATENTS[kind])).astype(np.float32)
            cases[kind] = dict(init=(perturb(params, np.random.default_rng(20 + i)),
                                     perturb(stats, np.random.default_rng(30 + i))),
                               raws=[raw_clips(40 + 10 * i + s, clips, frames, amplitude=4) for s in range(steps)],
                               eps=[eps] * steps, fsdp=fsdp)
        spec = dict(cases=cases, run_dir=str(tmp / "runs"))
        with cf.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(mesh.launch, ptr.reconstruct_cases, 2, spec, device="cpu", tmp_dir=str(tmp))
            jax_out = {kind: jax_run(kind, case) for kind, case in cases.items()}
            video_specs = dict(flat(jax.tree_util.tree_map(lambda s: tuple(s.spec),
                                                           fsdp_sharding(cases["Video"]["init"][0], make_mesh(2)))))
            out = ranks.result()
        yield dict(spec=spec, ranks=out, jax=jax_out, video_specs=video_specs,
                   checkpoint=f"{spec['run_dir']}/par/epoch_final.ckpt")


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_match_jax_mesh(world, kind):
    got, want = world["ranks"][0][kind], world["jax"][kind]
    case = world["spec"]["cases"][kind]
    steps = len(case["raws"])
    assert len(got["metrics"]) == len(want["metrics"]) == steps
    for mine, theirs in zip(got["metrics"], want["metrics"]):
        assert mine.keys() == theirs.keys() == {"loss", "mse", "huber", "latent_loss"}
        for name in mine:
            np.testing.assert_allclose(mine[name], float(theirs[name]), rtol=1e-4, err_msg=name)
    init_p, init_s = (dict(flat(t)) for t in case["init"])
    want_p, want_s = (dict(flat(t)) for t in want["final"])
    assert got["params"].keys() == want_p.keys()
    bn = kind in ("Audio", "Video")  # every leaf passes the train-mode BNs' rounding on to its gradient
    for key, value in got["params"].items():
        init = ptr.sampled(init_p[key])
        d_got, d_want = value - init, ptr.sampled(want_p[key]) - init
        gap = np.abs(d_got - d_want)
        assert np.all(gap <= ptr.update_bound(steps, init)), (key, float(gap.max() / LR))
        if bn:
            continue
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_want), key
    # the gradients: Adam's first moments (0.1 g2 + 0.09 g1 after two steps); a gradient N times too large or too
    # small, which the updates do not show, reads |1 - N| or |1 - 1/N| here
    want_mu = dict(flat(want["mu"]))
    assert got["mu"].keys() == want_mu.keys()
    num = den = 0.0
    for key, value in got["mu"].items():
        if bn and re.fullmatch(r"model/layer\d+/(conv|pool)_\d/bias", key):
            continue  # a conv bias that a train-mode BN follows: true gradient zero
        theirs = ptr.sampled(want_mu[key]).astype(np.float64)
        gap = float(np.linalg.norm(value - theirs) / max(np.linalg.norm(theirs), 1e-30))
        assert gap <= (0.5 if bn else 5e-2), (key, gap)
        num, den = num + float(np.sum((value - theirs) ** 2)), den + float(np.sum(theirs**2))
    assert np.sqrt(num / den) <= (5e-2 if bn else 1e-3), float(np.sqrt(num / den))
    assert got["stats"].keys() == want_s.keys() and bool(want_s) == bn
    for key, value in got["stats"].items():
        moved = np.abs(want_s[key] - init_s[key]).max()
        assert moved > 0 and np.abs(value - want_s[key]).max() <= 1e-3 * moved, key


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_hold_the_same_state_and_metrics(world, kind):
    a, b = (world["ranks"][r][kind] for r in (0, 1))
    assert a["digest"] == b["digest"] and a["metrics"] == b["metrics"]
    for key in a["stats"]:
        np.testing.assert_array_equal(a["stats"][key], b["stats"][key], err_msg=key)


def test_video_vae_shards_as_jaxs_fsdp_rule(world):
    got = world["ranks"][0]["Video"]
    task = ReconstructTask(ReconstructConfig(encoder_type="Video", compute_dtype="float32"), device="cpu")
    name_of = {id(p): n for n, p in task.named_parameters()}
    want = sorted(name_of[id(t)] for t, coll, path, _ in bridge.targets(task)
                  if coll == "params" and any(a is not None for a in world["video_specs"]["/".join(path)]))
    assert got["sharded"] == want and "model.vae.mean.weight" in want
    whole = sum(p.numel() for p in task.parameters()) * 2 * 4
    assert got["moments"] < 0.6 * whole
    assert world["ranks"][0]["Audio"]["sharded"]  # the small sound VAE's largest kernels
    assert all(not world["ranks"][0][kind]["sharded"] for kind in ("Ac", "Energy"))


def test_checkpoint_from_two_ranks_restores_at_one(world):
    """The ``Audio`` run's final state, FSDP's shards gathered whole and
    written by rank 0 at two ranks, restores at one process bit for bit:
    parameters, statistics, Adam's moments and step."""
    path = world["checkpoint"]
    case = world["spec"]["cases"]["Audio"]
    trainer = Trainer(ReconstructTask(ReconstructConfig(encoder_type="Audio", compute_dtype="float32"),
                                      device="cpu").init_params(99))
    state = trainer.restore(path, trainer.init_state())
    assert state.step == len(case["raws"])
    sd = ckpt.state_dict(state)
    got = world["ranks"][0]["Audio"]
    for tree, ref in ((sd["params"], got["params"]), (sd["opt_state"]["0"]["mu"], got["mu"]),
                      (sd["batch_stats"], got["stats"])):
        leaves = dict(flat(tree))
        assert leaves.keys() == ref.keys()
        for key, value in leaves.items():
            np.testing.assert_array_equal(value, ref[key], err_msg=key)
    assert ckpt.read_state_dict(path)["step"] == len(case["raws"])
