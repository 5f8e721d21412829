"""Tensor parallelism (``parallel/mesh.py``: ``tensor_parallel=2``, two
ranks at ``(data 1, model 2)``, gloo on the CPU) for the embedding family's
default variant and the ``Video`` and ``Ac`` reconstructions, against JAX's
``Trainer(tensor_parallel=2)`` on a two-device ``(1, 2)`` CPU mesh, in f32
at full width: one step of 2 one-second clips (embedding), 2 clips of one
frame (``Video``) or of 2 frames (``Ac``). The video VAE's wide convs
(``layer3``, ``layer5``, ``conv_dec``, ``upsample_6``, ``layer6``,
``layer7``, and for ``Video`` its head's 1024-channel mean and std) are
split over the model group and trained, so their backward runs through
both collectives; ``Ac``'s VAE has no kernel the rule splits, so the grid
only makes its two ranks share rows.

One spawn of two ranks (``tests/tensor_parallel_ranks.py``) runs every
port case while JAX compiles in this process. The same weights (the
port's ``init_params``, biases, BN parameters and statistics drawn away
from their initial values) and the same noise (a numpy draw at the global
shape, handed to the port as ``eps`` and to JAX in place of its
``jax.random.normal``) go into both.

Tolerances (``tests/test_torch_parallel_reconstruct.py``'s and
``tests/test_torch_parallel_embed.py``'s, and why): the losses and terms
within 1e-4 relative (through the train-mode BNs, whose fast-variance
cancellation magnifies rounding); each trained tensor's update within
``parallel_task_ranks.update_bound`` entry by entry (2 lr and rounding),
and for ``Ac`` (no BN) also 99% within lr/4 and 10% in L2; Adam's first
moments (the gradients, which the updates cannot show), compared whole
after the gather, in L2: within 0.5 of JAX's a leaf and 5e-2 a module
(``layer3``, ``vae``, ...) and over the VAE for the BN VAEs, the biases that
a train-mode BN follows left out (true gradient zero), and within 5e-2 a
leaf and 1e-3 over the VAE for ``Ac``; a gradient N times too large or too
small reads |1 - N| or |1 - 1/N| there, so a ``gather_channels`` backward
that sums the peers' replicated gradients (2x at the last split conv, more
above it) fails; the BN running averages within 1e-3 of how far they
moved; the two ranks against each other bit for bit in every replicated
tensor, and in what each computed itself (its loss terms and a digest of
its replicated gradients and BN statistics, ``Trainer.own_steps``) before
the trainer makes those model rank 0's; each rank holds half of every split kernel and of its Adam slots.
The two largest leaves of ``Video``'s VAE (its head's convs, 100M entries
each) are held on every stride-th entry (``parallel_task_ranks.sampled``).
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
import tensor_parallel_ranks as tpr
from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.train.embed import EmbedTask as JaxEmbed
from acoustic_image_generation_tpu.train.reconstruct import ReconstructTask as JaxReconstruct
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.reconstruct import LATENTS, ReconstructConfig, ReconstructTask
from task_parity import raw_clips
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
CASES = {  # clips, frames, latent
    "embed": (2, 12, 128),
    "Video": (2, 1, LATENTS["Video"]),
    "Ac": (2, 2, LATENTS["Ac"]),
}
BN = ("embed", "Video")  # the cases whose VAE has train-mode BNs


def jax_cfg(name):
    clips = CASES[name][0]
    model = ModelConfig(embedding=True) if name == "embed" else ModelConfig(model="UNet", encoder_type=name)
    return ExperimentConfig(data=DataConfig(batch_size=clips, sample_length=1), model=model,
                            optim=OptimConfig(learning_rate=LR), run=RunConfig(checkpoint_dir="unused"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=2, tensor_parallel=2))


@contextlib.contextmanager
def jax_noise(eps):
    """JAX's latent draws are ``eps`` (a constant of the traced program)."""
    normal = jax.random.normal

    def fixed(key, shape, dtype=jnp.float32):
        assert tuple(shape) == eps.shape, (shape, eps.shape)
        return jnp.asarray(eps, dtype)

    jax.random.normal = fixed
    try:
        yield
    finally:
        jax.random.normal = normal


def jax_run(name, case):
    """JAX's Trainer on its ``(1, 2)`` mesh, its state placed by
    ``tp_sharding``: the step's metrics, the new parameters and BN
    statistics, and Adam's first moments."""
    cfg = jax_cfg(name)
    jtr = JaxTrainer(JaxEmbed(cfg) if name == "embed" else JaxReconstruct(cfg), cfg)
    raws = [JaxRawBatch(r["acoustic"], r["audio"], r["video"], r["action"], r["location"], r["audio"].shape[0])
            for r in case["raws"]]
    state = jtr.init_state(raws[0])
    state = jax.device_put(state.replace(params=case["init"][0], batch_stats=case["init"][1]), jtr._state_shardings)
    metrics = []
    with jax_noise(case["eps"]):
        for raw in raws:
            state, m = jtr.train_step(state, raw)
            metrics.append(jax.device_get(m))
    (adam,) = [s for s in jax.tree_util.tree_leaves(state.opt_state, is_leaf=lambda s: isinstance(s, ScaleByAdamState))
               if isinstance(s, ScaleByAdamState)]
    specs = jax.tree_util.tree_map(lambda s: tuple(s.spec), jtr._state_shardings.params)
    return dict(metrics=metrics, final=jax.device_get((state.params, state.batch_stats)), mu=jax.device_get(adam.mu),
                specs=dict(flat(specs)))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def port_task(name):
    if name == "embed":
        return EmbedTask(EmbedConfig(compute_dtype="float32"), device="cpu")
    return ReconstructTask(ReconstructConfig(encoder_type=name, compute_dtype="float32"), device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the spawn of two ranks (in a thread) and JAX's runs."""
    with module_dir(tmp_path_factory, "tensor_parallel_tasks", need_mb=1500) as tmp:  # the ranks' results
        cases = {}
        for i, (name, (clips, frames, latent)) in enumerate(CASES.items()):
            params, stats = bridge.to_flax(port_task(name).init_params(i))
            samples = clips if name == "embed" else clips * frames
            cases[name] = dict(init=(perturb(params, np.random.default_rng(20 + i)),
                                     perturb(stats, np.random.default_rng(30 + i))),
                               raws=[raw_clips(40 + i, clips, frames, amplitude=4)],
                               eps=np.random.default_rng(10 + i).standard_normal((samples, latent)).astype(np.float32))
        spec = dict(cases=cases)
        with cf.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(mesh.launch, tpr.task_cases, 2, spec, device="cpu", tmp_dir=str(tmp))
            jax_out = {name: jax_run(name, case) for name, case in cases.items()}
            out = ranks.result()
        yield dict(spec=spec, ranks=out, jax=jax_out)


def _bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"^(model|video)/layer\d+/(conv|pool)_\d/bias$", key))


@pytest.mark.parametrize("name", CASES)
def test_losses_and_updates_match_jax_tp_mesh(world, name):
    got, want = world["ranks"][0][name], world["jax"][name]
    case = world["spec"]["cases"][name]
    for mine, theirs in zip(got["metrics"], want["metrics"], strict=True):
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k], float(theirs[k]), rtol=1e-4, err_msg=k)
    init_p = dict(flat(case["init"][0]))
    want_p = dict(flat(want["final"][0]))
    top = "video" if name == "embed" else "model"
    assert got["params"].keys() == {k for k in want_p if k.startswith(top + "/")}
    for key, value in got["params"].items():
        init = ptr.sampled(init_p[key])
        gap = np.abs((value - init) - (ptr.sampled(want_p[key]) - init))
        assert np.all(gap <= ptr.update_bound(1, init)), (key, float(gap.max() / LR))
        if name in BN:
            continue
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(ptr.sampled(want_p[key]) - init), key


@pytest.mark.parametrize("name", CASES)
def test_adam_first_moments_are_the_whole_gradients(world, name):
    """Adam's first moments of the split and the whole convs, each gathered
    whole, against JAX's: a leaf, a module and the VAE in L2."""
    got, want = world["ranks"][0][name]["mu"], dict(flat(world["jax"][name]["mu"]))
    bn = name in BN
    sums: dict = {}
    for key, value in got.items():
        if bn and _bn_cancelled(key):
            continue
        theirs = ptr.sampled(np.asarray(want[key])).astype(np.float64)
        gap = float(np.linalg.norm(value - theirs) / max(np.linalg.norm(theirs), 1e-30))
        assert gap <= (0.5 if bn else 5e-2), (key, gap)
        for part in (key.split("/")[1], "all"):
            num, den = sums.get(part, (0.0, 0.0))
            sums[part] = (num + float(np.sum((value - theirs) ** 2)), den + float(np.sum(theirs**2)))
    for part, (num, den) in sums.items():
        limit = 1e-3 if not bn and part == "all" else 5e-2
        assert np.sqrt(num / den) <= limit, (part, float(np.sqrt(num / den)))


@pytest.mark.parametrize("name", CASES)
def test_running_averages_match_jax_tp_mesh(world, name):
    got = world["ranks"][0][name]["stats"]
    want, init = dict(flat(world["jax"][name]["final"][1])), dict(flat(world["spec"]["cases"][name]["init"][1]))
    assert got.keys() == want.keys() and bool(want) == (name in BN)
    for key, value in got.items():
        moved = np.abs(want[key] - init[key]).max()
        assert moved > 0 and np.abs(value - want[key]).max() <= 1e-3 * moved, key


@pytest.mark.parametrize("name", CASES)
def test_peers_hold_the_same_replicated_state(world, name):
    a, b = (world["ranks"][r][name] for r in (0, 1))
    assert a["replicated"] == b["replicated"] and a["metrics"] == b["metrics"]
    assert len(a["own"]) == len(a["metrics"]) and a["own"] == b["own"]
    for key in a["stats"]:
        np.testing.assert_array_equal(a["stats"][key], b["stats"][key], err_msg=key)


@pytest.mark.parametrize("name", CASES)
def test_split_kernels_and_moments_are_halves(world, name):
    """The kernels the port splits are those JAX's ``tp_sharding`` puts on
    the ``model`` axis, and each rank holds half of them and of their Adam
    slots."""
    specs = world["jax"][name]["specs"]
    task = port_task(name)  # uninitialized: names and shapes only
    name_of = {id(t): n for n, t in task.named_parameters()}
    want = sorted(name_of[id(t)] for t, coll, path, _ in bridge.targets(task)
                  if coll == "params" and "model" in specs["/".join(path)])
    for r in (0, 1):
        got = world["ranks"][r][name]
        assert sorted(got["split"]) == want
        if not want:
            assert got["bytes"] == got["slot_bytes"] == 0
            continue
        assert 2 * got["bytes"] == got["whole_bytes"] and 2 * got["slot_bytes"] == got["whole_slot_bytes"] > 0
    assert len(want) == {"embed": 11, "Video": 13, "Ac": 0}[name]
