"""The classification family and the correspondence augmentation on two
ranks (``parallel/mesh.py``: one process a device, gloo on the CPU) against
JAX's one program over a two-device CPU mesh, in f32: one step of DualCamNet
on real acoustic images and on the tiled MFCC map, of the generated
classifier (ResNet 1/1/1/1 under the full-width generator), of the
correspondence task on the silence map, on the zeroed video and on the
music shuffle, and of the generation task with the correspondence
augmentation (zeroed video, ResNet 1/1/1/1); 4 clips of 12 frames a global
batch (the generated classifier 2, the generation task 4 of 2 frames), half
a rank.

One spawn of two ranks (``tests/parallel_family_ranks.py``) runs every port
case while JAX compiles in this process: each case under DDP, DualCamNet on
real images, the music shuffle and the generation task also under FSDP (the
first's state written and restored at one process); ``evaluate`` over
remainder batches of the real images, the silence map and the music
shuffle. The same weights (the port's ``init_params(0)``, biases, BN
parameters and statistics drawn away from their initial values), the same
noise (a numpy draw at the global shape, handed to the port as ``eps`` and
to JAX in place of its ``jax.random.normal``) and the same shuffle (the
permutations the port's trainer draws at the global clip count, handed to
JAX in place of its ``jax.random.permutation``) go into both. JAX's side is
one jitted program: each case's ``Trainer`` on the two-device mesh
(``device_batch``, ``_prepare`` with the step's keys) and the gradient of
its loss; its TF1 Adam (``adam_tf1``) takes the step.

Tolerances, and why:

- the losses and terms within 1e-4 relative, the accuracies exact; the
  silence map within 2e-3 of JAX's, as ``tests/test_torch_classify.py``
  holds it (its fake half is the MFCC of low-passed audio, whose upper mel
  bands differ between the two packages by up to 1e-2), and within 1e-5 of
  one process of the port;
- each trained tensor's update within 2 lr entry by entry
  (``parallel_task_ranks.update_bound``);
- Adam's first moments (0.1 of the gradient, which the update cannot show:
  a gradient N times too large or too small reads |1 - N| or |1 - 1/N|
  here) in L2 over DualCamNet within 1e-3 of JAX's and 5e-2 a leaf; over
  the generation task's trained modules (train-mode BN in the trunk's
  ``conv_map``) 5e-2 and 0.5 a leaf, the biases a train-mode BN follows
  left out, as ``tests/test_torch_parallel_reconstruct.py`` holds the BN
  VAEs; a leaf whose gradient is below ``LEAF_FLOOR`` of its module's
  (rounding level) is held by its module's bound alone;
- the generation task's running averages within 1e-3 of how far they
  moved;
- the two ranks against each other, the music shuffle's prepared batch
  against one process's cut to the rank's clips, the generation task's
  drawn noise against one process's draw cut to the rank's rows of each
  half, the checkpoint restored at one process: bit for bit; ``evaluate`` against one process at 1e-5
  relative, the accuracy exact.
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

import parallel_family_ranks as pfr
import parallel_task_ranks as ptr
from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.train import classify as jclassify
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxGeneration
from acoustic_image_generation_tpu.train.optim import adam_tf1
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.data import preprocess
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, data_generator, step_generator
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
CASES = {  # clips, frames a clip of each case's global batch
    "real": (4, 12), "mfccmap": (4, 12), "generated": (2, 12), "augment": (4, 12), "no_video": (4, 12),
    "music": (4, 12), "generation": (4, 2)}
FSDP = ("real", "music", "generation")
EVAL = ("real", "augment", "music")
LEAF_FLOOR = 1e-3  # see tests/test_torch_parallel_project.py
JAX_TASK = {"generated": jclassify.GeneratedClassificationTask, "augment": jclassify.CorrespondenceTask,
            "no_video": jclassify.CorrespondenceTask, "music": jclassify.CorrespondenceTask,
            "generation": JaxGeneration}
TRAINED = {name: ("resnet", "generator") if name == "generation" else ("dualcamnet",) for name in CASES}


def raw_clips(seed, name, valid=None):
    """A global batch of the case's clips (music: 13 channels, actions and
    locations in {0, 1} so that some shuffled pairs match); ``valid`` <
    clips repeats the last valid clip in the rest (a remainder batch, as
    the loader pads it)."""
    clips, frames = CASES[name]
    rng = np.random.default_rng(seed)
    music = name == "music"
    f = (clips, frames)
    raw = dict(acoustic=rng.random((*f, 36, 48, 13 if music else 12), dtype=np.float32),
               audio=rng.integers(-(2**15), 2**15, (*f, 1024)).astype(np.int32),
               video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
               action=rng.integers(0, 2 if music else 10, clips).astype(np.int32),
               location=rng.integers(0, 2 if music else 61, clips).astype(np.int32))
    if valid is not None:
        for v in raw.values():
            v[valid:] = v[valid - 1]
        raw["valid"] = valid
    return raw


def jax_cfg(name):
    clips, _ = CASES[name]
    task = pfr.CLASSIFY[name]
    data = dict(correspondence=task.get("correspondence", False),
                correspondence_video=task.get("correspondence_video", False),
                datatype=task.get("datatype", "outdoor"))
    if name == "generation":
        model = dict(embedding=True, mfcc=True, resnet_units=pfr.UNITS)
    else:
        model = dict(model="DualCamNet", resnet_units=pfr.UNITS, mfcc=name in ("real", "mfccmap"),
                     mfccmap=name == "mfccmap")
    return jconfig.ExperimentConfig(data=jconfig.DataConfig(batch_size=clips, sample_length=1, **data),
                                    model=jconfig.ModelConfig(**model), optim=jconfig.OptimConfig(learning_rate=LR),
                                    run=jconfig.RunConfig(checkpoint_dir="unused"),
                                    parallel=jconfig.ParallelConfig(compute_dtype="float32", num_devices=2))


def music_perms(clips):
    """The permutations the port's trainer draws for step 0's music shuffle
    of ``clips`` global clips."""
    return preprocess.shuffle_permutations(clips, data_generator(0, 0), final_shuffle=True)


@contextlib.contextmanager
def jax_draws(normals: list, perms: list):
    """JAX's ``jax.random.normal`` returns ``normals`` and its
    ``jax.random.permutation`` ``perms``, each in order: constants of the
    traced program."""
    normal, permutation = jax.random.normal, jax.random.permutation
    queues = iter(normals), iter(perms)

    def fixed_normal(key, shape, dtype=jnp.float32):
        value = next(queues[0])
        assert tuple(shape) == value.shape, (shape, value.shape)
        return jnp.asarray(value, dtype)

    def fixed_permutation(key, n, *args, **kw):
        value = next(queues[1])
        assert value.shape == (n,), (n, value.shape)
        return jnp.asarray(value)

    jax.random.normal, jax.random.permutation = fixed_normal, fixed_permutation
    try:
        yield
        assert next(queues[0], None) is None and next(queues[1], None) is None, "JAX drew fewer than handed in"
    finally:
        jax.random.normal, jax.random.permutation = normal, permutation


def jax_program(cases: dict):
    """JAX's program on each case's Trainer on a two-device mesh:
    ``{case: (metrics, new batch_stats, gradient of every parameter)}``."""
    tasks = {n: JAX_TASK.get(n, jclassify.ClassificationTask)(jax_cfg(n)) for n in CASES}
    trainers = {n: JaxTrainer(tasks[n], jax_cfg(n)) for n in CASES}

    def program(trees, device_raws):
        out = {}
        for name in CASES:
            trainer = trainers[name]
            rngs = jrng.train_step_rngs(trainer.base_key, 0)
            batch = trainer._prepare(device_raws[name], key=rngs["data"])
            params, stats = trees[name]

            def loss(p, name=name, stats=stats, batch=batch, rngs=rngs):
                total, metrics, new_stats = tasks[name].loss(p, stats, batch, rngs, train=True)
                return total, (metrics, new_stats)

            (_, (metrics, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)
            out[name] = (metrics, new_stats, grads)
        return out

    device_raws = {n: trainers[n].device_batch(JaxRawBatch(*(cases[n]["raw"][k] for k in (
        "acoustic", "audio", "video", "action", "location")), CASES[n][0])) for n in CASES}
    trees = jax.device_put({n: cases[n]["init"] for n in CASES}, trainers["real"]._replicated)
    normals = [cases[n]["eps"] for n in ("generated", "generation")]
    perms = [np.asarray(p) for p in music_perms(CASES["music"][0])]
    with jax_draws(normals, perms):
        return jax.device_get(jax.jit(program)(trees, device_raws))


def adam_step(params: dict, grads: dict) -> dict:
    """The parameters after one step of TF1 Adam from ``grads``."""
    tx = adam_tf1(LR)

    @jax.jit
    def step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    return jax.device_get(step(params, grads))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


class GlobalLoader:
    """One process's loader of the global batches (dicts with ``valid``)."""

    def __init__(self, raws):
        self.raws = raws

    def batches(self, epoch=0):
        yield from self.raws


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the spawn of two ranks (in a thread), JAX's program and
    one process's evaluations, music batch and restored checkpoint."""
    with module_dir(tmp_path_factory, "parallel_classify", need_mb=300) as tmp:
        rng = np.random.default_rng(1)
        cases = {}
        for i, name in enumerate(CASES):
            task = pfr.classify_task(name)
            init = tuple(perturb(t, rng) for t in bridge.to_flax(task))
            clips, frames = CASES[name]
            rows = clips * frames * (2 if name == "generation" else 1)
            eps = rng.standard_normal((rows, 150)).astype(np.float32) if name in ("generated", "generation") \
                else None
            cases[name] = dict(init=init, raw=raw_clips(10 + i, name), eps=eps)
            del task
        eval_raws = {n: [raw_clips(30 + i, n, valid=CASES[n][0]), raw_clips(40 + i, n, valid=1)]
                     for i, n in enumerate(EVAL)}
        spec = dict(cases=cases, fsdp=FSDP, eval_raws=eval_raws, run_dir=str(tmp / "runs"))
        with cf.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(mesh.launch, pfr.classify_cases, 2, spec, device="cpu", tmp_dir=str(tmp))
            jax_out = jax_program(cases)
            one = {}
            for name in EVAL:  # one process: evaluate over the same batches
                trainer = Trainer(pfr.classify_task(name, cases[name]["init"]))
                one[f"{name} eval"] = trainer.evaluate(trainer.init_state(), GlobalLoader(eval_raws[name]),
                                                       use_cache=False)
            trainer = Trainer(pfr.classify_task("augment", cases["augment"]["init"]))  # the silence map's step
            _, metrics = trainer.train_step(trainer.init_state(), cases["augment"]["raw"])
            one["augment"] = {k: float(v) for k, v in metrics.items()}
            trainer = Trainer(pfr.classify_task("music", cases["music"]["init"]))  # the music shuffle's batch
            batch = trainer._prepare(cases["music"]["raw"], generator=data_generator(0, 0))
            one["music batch"] = {k: None if v is None else v.numpy() for k, v in batch._asdict().items()}
            out = ranks.result()
            trainer = Trainer(pfr.classify_task("real", cases["real"]["init"]))
            sd = ckpt.state_dict(trainer.restore(f"{spec['run_dir']}/par/epoch_final.ckpt", trainer.init_state()))
            one["restored"] = dict(step=int(sd["step"]), params=dict(flat(sd["params"])),
                                   mu=dict(flat(sd["opt_state"]["0"]["mu"])))
        yield dict(spec=spec, ranks=out, jax=jax_out, one=one)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"/(conv|pool)_\d/bias$|/conv_map/conv/bias$", key))


CHECKED = [*CASES, *(f"{n} fsdp" for n in FSDP)]


@pytest.mark.parametrize("case", CHECKED)
def test_ranks_match_jax_mesh(world, case):
    name = case.split()[0]
    got = world["ranks"][0][case]
    metrics, new_stats, grads = world["jax"][name]
    (step,) = got["metrics"]
    assert step.keys() == metrics.keys()
    for key, value in step.items():
        tol = 2e-3 if name == "augment" else 0 if key == "accuracy" else 1e-4
        np.testing.assert_allclose(value, float(metrics[key]), rtol=tol, atol=1e-7 if key == "accuracy" else 0,
                                   err_msg=key)
    init_p, init_s = world["spec"]["cases"][name]["init"]
    trained = {k: v for k, v in dict(flat(init_p)).items() if k in got["params"]}
    want_g = {k: v for k, v in dict(flat(grads)).items() if k in trained}
    assert trained.keys() == want_g.keys() == got["mu"].keys() and trained
    new = dict(flat(adam_step(trained, want_g)))
    bn = name == "generation"
    norm = {m: np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for k, g in want_g.items()
                           if k.split("/")[0] == m)) for m in TRAINED[name]}
    sums = {m: [0.0, 0.0] for m in TRAINED[name]}
    for key, g in want_g.items():
        module = key.split("/")[0]
        gap = np.abs((got["params"][key] - trained[key]) - (new[key] - trained[key]))
        assert np.all(gap <= ptr.update_bound(1, trained[key])), (key, float(gap.max() / LR))
        if bn and bn_cancelled(key):
            continue
        mine = got["mu"][key].astype(np.float64) / 0.1
        sums[module][0] += float(np.sum((mine - g) ** 2))
        sums[module][1] += float(np.sum(np.asarray(g, np.float64) ** 2))
        if np.linalg.norm(g) >= LEAF_FLOOR * norm[module]:
            assert rel_l2(mine, g) <= (0.5 if bn else 5e-2), (key, rel_l2(mine, g))
    for module, (num, den) in sums.items():
        if den:
            assert np.sqrt(num / den) <= (5e-2 if bn else 1e-3), (module, float(np.sqrt(num / den)))
    # the running averages: the generation task's moved as JAX's; DualCamNet has none
    init_s, want_s = dict(flat(init_s)), dict(flat(new_stats))
    assert bool(got["stats"]) == bn
    for key, value in got["stats"].items():
        moved = np.abs(want_s[key] - init_s[key]).max()
        assert moved > 0 and np.abs(value - want_s[key]).max() <= 1e-3 * moved, key


@pytest.mark.parametrize("case", CHECKED)
def test_ranks_hold_the_same_state_and_metrics(world, case):
    a, b = (world["ranks"][r][case] for r in (0, 1))
    assert a["digest"] == b["digest"] and a["metrics"] == b["metrics"]


def test_silence_map_step_matches_one_process(world):
    got, want = world["ranks"][0]["augment"]["metrics"][0], world["one"]["augment"]
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_music_shuffle_pairs_clips_across_ranks(world):
    """The shuffle draws its permutations at the global clip count: some
    clip's partner sits on the other rank, and each rank's prepared batch
    is one process's shuffled batch cut to the rank's clips."""
    clips, frames = CASES["music"]
    clip_perm, _ = music_perms(clips)
    owner = lambda c: c // (clips // 2)
    assert any(owner(int(p)) != owner(i) for i, p in enumerate(clip_perm))
    want = world["one"]["music batch"]
    for r in (0, 1):
        got = world["ranks"][r]["music"]["batch"]
        assert got.keys() == want.keys()
        for key, value in want.items():
            if value is None:
                assert got[key] is None, key
                continue
            np.testing.assert_allclose(got[key], mesh.shard_rows(value, r, 2), rtol=1e-6, atol=1e-6, err_msg=key)
            if value.dtype.kind == "i" or key == "correspondence":
                np.testing.assert_array_equal(got[key], mesh.shard_rows(value, r, 2), err_msg=key)


def test_doubled_batch_noise_is_cut_by_halves(world):
    """The generation task's noise for the batch the correspondence
    augmentation doubled: one process's draw for the global doubled batch,
    of which each rank keeps its rows of each half (its own rows, then their
    copies), as each rank doubles its rows."""
    clips, frames = CASES["generation"]
    rows = 2 * clips * frames
    want = torch.randn((rows, 150), generator=step_generator(0, 0, "cpu")).numpy()
    for r in (0, 1):
        got = world["ranks"][r]["generation"]["eps"]
        np.testing.assert_array_equal(got, np.concatenate([mesh.shard_rows(want[:rows // 2], r, 2),
                                                           mesh.shard_rows(want[rows // 2:], r, 2)]))


@pytest.mark.parametrize("name", EVAL)
def test_evaluate_with_a_remainder_batch_matches_one_process(world, name):
    want = world["one"][f"{name} eval"]
    for r in (0, 1):
        got = world["ranks"][r][name]["eval"]
        assert got.keys() == want.keys() == {"cross_loss", "accuracy"}
        np.testing.assert_allclose(got["cross_loss"], want["cross_loss"], rtol=1e-5, err_msg=(name, r))
        assert got["accuracy"] == want["accuracy"], (name, r)


def test_fsdp_keeps_what_jax_keeps_whole(world):
    """JAX's ``fsdp_sharding`` shards a leaf of 2^18 entries or more: of
    DualCamNet's, none, so FSDP keeps every tensor whole; the generation
    task's generator and ``conv_map`` have such leaves."""
    assert world["ranks"][0]["real fsdp"]["sharded"] == []
    assert world["ranks"][0]["generation fsdp"]["sharded"]
    assert world["ranks"][0]["generation fsdp"]["moments"] < 0.9 * world["ranks"][0]["generation"]["moments"]


def test_checkpoint_from_two_ranks_restores_at_one(world):
    """DualCamNet's FSDP state, written by rank 0 at two ranks, restores at
    one process bit for bit: its parameters, Adam's moments and the
    step."""
    got, restored = world["ranks"][0]["real fsdp"], world["one"]["restored"]
    assert restored["step"] == 1
    for key, value in got["params"].items():
        np.testing.assert_array_equal(restored["params"][key], value, err_msg=key)
        np.testing.assert_array_equal(restored["mu"][key], got["mu"][key], err_msg=key)
