"""Tensor parallelism (``parallel/mesh.py``: ``tensor_parallel=2``) with the
correspondence augmentation, on four ranks at ``(data 2, model 2)`` (gloo
on the CPU), so that a data group has two ranks and differs from the
world, against JAX's ``Trainer(tensor_parallel=2)`` on a four-device
``(2, 2)`` CPU mesh (its state placed by ``tp_sharding``) and against the
port's one process, in f32: one step of the generation task with the
silence map and with the zeroed video (``trunk_bn="frozen"``, ResNet
1/1/1/1 under the full-width generator, 4 clips of 2 frames, doubled to 8),
of the correspondence task on the silence map (the ``filtfilt`` branch on
the CPU's plain version) and on the music shuffle (4 clips of 12 frames a
global batch, 2 a data rank).

The generation task's 12 wide trunk convs are split over each model group
and run on the doubled batch; DualCamNet has nothing to split, so there the
grid only decides which ranks share rows. The rows, the doubled batch's
noise and the music shuffle go by the data group: the peers of a model
group hold the same rows, draw the same permutations (at the data group's
global clip count, from the same generator) and gather the same rows.

One spawn of four ranks (``tests/tensor_parallel_ranks.py``) runs every
port case while JAX compiles in this process and the one process runs
beside it: the same weights (the port's ``init_params(0)``, biases, BN
parameters and statistics drawn away from their initial values, carried
across by ``bridge.py``), the same noise (a numpy draw at the global shape
of the doubled batch, handed to the port as ``eps`` and to JAX in place of
its ``jax.random.normal``) and the same shuffle (the permutations one
process draws, handed to JAX in place of its ``jax.random.permutation``).

Tolerances (``tests/test_torch_parallel_classify.py``'s, for their
reasons):

- the losses and terms within 1e-4 relative of JAX's, the accuracies
  exact; the silence map's within 2e-3 (its fake half is the MFCC of
  low-passed audio, whose upper mel bands differ between the two packages
  by up to 1e-2, as ``tests/test_torch_classify.py`` holds it); within
  1e-5 of the port's one process;
- each trained tensor's update within ``parallel_task_ranks.update_bound``
  of JAX's;
- Adam's first moments (0.1 of the gradient) in L2: over DualCamNet 1e-3
  of JAX's and 5e-2 a leaf; over the generation task's trained modules
  (the train-mode BN of ``conv_map``) 5e-2 and 0.5 a leaf, the biases a
  train-mode BN follows left out (true gradient zero); a leaf below
  ``LEAF_FLOOR`` of its module's gradient (rounding level) is held by its
  module's bound alone; the silence map's generation step, whose fake
  half's inputs differ as above, at the generation task's bounds too;
- the running averages that JAX's step moves within 1e-3 of how far they
  moved, the frozen trunk's bit-frozen;
- the four ranks against each other bit for bit in every replicated tensor
  and metric, and the peers of each model group in what each computed
  before the trainer's broadcast (``Trainer.own_steps``); the permutations
  on every rank and one process's, and the doubled batch's drawn noise
  against one process's cut to the data rank's rows of each half, bit for
  bit; the music shuffle's prepared batch one process's cut to the data
  rank's clips, its labels bit for bit and its float entries within 1e-6
  (each rank preprocesses its rows at its own batch size); ``evaluate``
  over remainder batches against one process at 1e-5 relative, the
  accuracy exact.
"""

import concurrent.futures as cf
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch

import parallel_family_ranks as pfr
import parallel_task_ranks as ptr
import tensor_parallel_ranks as tpr
import test_torch_parallel_classify as tpc
from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.parallel import tp_sharding
from acoustic_image_generation_tpu.train import classify as jclassify
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxGeneration
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, OptimConfig
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, data_generator, step_generator
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
CASES = tuple(tpr.CORRESPONDENCE)  # generation augment, generation no_video, augment, music
RAW = {"generation augment": "generation", "generation no_video": "generation", "augment": "augment",
       "music": "music"}  # test_torch_parallel_classify.py's batch of each: clips and frames, channels
EVAL = ("augment", "music")
SILENCE = ("generation augment", "augment")  # the fake half is the low-passed audio's MFCC
GENERATION = ("generation augment", "generation no_video")
LEAF_FLOOR = tpc.LEAF_FLOOR
N, TP = 4, 2


def jax_cfg(case):
    clips, _ = tpc.CASES[RAW[case]]
    data = jconfig.DataConfig(batch_size=clips, sample_length=1, correspondence=True,
                              correspondence_video=case == "generation no_video",
                              datatype="music" if case == "music" else "outdoor")
    if case in GENERATION:
        model = jconfig.ModelConfig(embedding=True, mfcc=True, resnet_units=pfr.UNITS, trunk_bn="frozen")
    else:
        model = jconfig.ModelConfig(model="DualCamNet", resnet_units=pfr.UNITS)
    return jconfig.ExperimentConfig(data=data, model=model, optim=jconfig.OptimConfig(learning_rate=LR),
                                    run=jconfig.RunConfig(checkpoint_dir="unused"),
                                    parallel=jconfig.ParallelConfig(compute_dtype="float32", num_devices=N,
                                                                    tensor_parallel=TP))


def jax_program(cases: dict):
    """Each case's Trainer at ``tensor_parallel=2`` on its ``(2, 2)`` mesh,
    the trees placed by ``tp_sharding``: ``({case: (metrics, new
    batch_stats, gradient of the trained modules, the trained modules after
    one step of its TF1 Adam)}, {case: flat partition specs})``."""
    tasks = {c: (JaxGeneration if c in GENERATION else jclassify.CorrespondenceTask)(jax_cfg(c)) for c in CASES}
    trainers = {c: JaxTrainer(tasks[c], jax_cfg(c)) for c in CASES}
    grid = trainers[CASES[0]].mesh
    assert dict(grid.shape) == {"data": 2, "model": 2}

    def program(trees, device_raws):
        out = {}
        for case in CASES:
            rngs = jrng.train_step_rngs(trainers[case].base_key, 0)
            batch = trainers[case]._prepare(device_raws[case], key=rngs["data"])
            params, stats = trees[case]

            def loss(p, case=case, params=params, stats=stats, batch=batch, rngs=rngs):
                total, metrics, new_stats = tasks[case].loss(dict(params, **p), stats, batch, rngs, train=True)
                return total, (metrics, new_stats)

            wrt = {k: params[k] for k in tpr.TRAINED[case]}
            (_, (metrics, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(wrt)
            out[case] = (metrics, new_stats, grads)
        return out

    device_raws = {c: trainers[c].device_batch(JaxRawBatch(*(cases[c]["raw"][k] for k in (
        "acoustic", "audio", "video", "action", "location")), tpc.CASES[RAW[c]][0])) for c in CASES}
    trees = {c: cases[c]["init"] for c in CASES}
    specs = {c: dict(tpc.flat(jax.tree_util.tree_map(lambda s: tuple(s.spec), tp_sharding(trees[c][0], grid))))
             for c in CASES}
    normals = [cases[c]["eps"] for c in GENERATION]
    perms = [np.asarray(p) for p in tpc.music_perms(tpc.CASES["music"][0])]
    with tpc.jax_draws(normals, perms):
        out = jax.device_get(jax.jit(program)(jax.device_put(trees, tp_sharding(trees, grid)), device_raws))
    trained = {c: {k: trees[c][0][k] for k in tpr.TRAINED[c]} for c in CASES}
    new = tpc.adam_step(trained, {c: out[c][2] for c in CASES})
    return {c: (*out[c], new[c]) for c in CASES}, specs


def inputs() -> dict:
    """Each case's flax trees (the two generation cases share theirs),
    global batch and noise for the doubled batch."""
    rng = np.random.default_rng(3)
    cases, trees = {}, {}
    for i, case in enumerate(CASES):
        family = "generation" if case in GENERATION else case
        if family not in trees:
            trees[family] = tuple(perturb(t, rng) for t in bridge.to_flax(tpr.case_task(case, None).init_params(0)))
        clips, frames = tpc.CASES[RAW[case]]
        eps = rng.standard_normal((2 * clips * frames, 150)).astype(np.float32) if case in GENERATION else None
        cases[case] = dict(init=trees[family], raw=tpc.raw_clips(50 + i, RAW[case]), eps=eps)
    return cases


def one_process(cases: dict, eval_raws: dict) -> dict:
    """The port's one process: each case's step from the same weights and
    noise, ``evaluate`` over the remainder batches, the music shuffle's
    prepared batch."""
    out = {}
    config = ExperimentConfig(optim=OptimConfig(learning_rate=LR))
    for case in CASES:
        c = cases[case]
        trainer = Trainer(tpr.case_task(case, c["init"]), config)
        state = trainer.init_state()
        if case in EVAL:
            out[f"{case} eval"] = trainer.evaluate(state, tpc.GlobalLoader(eval_raws[case]), use_cache=False)
        if case == "music":
            batch = trainer._prepare(c["raw"], generator=data_generator(0, 0))
            out["music batch"] = {k: None if v is None else v.numpy() for k, v in batch._asdict().items()}
        _, m = trainer.train_step(state, c["raw"], eps=c["eps"])
        out[case] = {k: float(v) for k, v in m.items()}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawn of four ranks (in a thread), the inputs, which they read
    from a file, JAX's program, and beside it (in another thread) the one
    process's runs."""
    with module_dir(tmp_path_factory, "tensor_parallel_correspondence", need_mb=1500) as tmp:
        spec = dict(inputs=str(tmp / "inputs.pkl"))
        with cf.ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(mesh.launch, tpr.correspondence_cases, N, spec, device="cpu", tmp_dir=str(tmp))
            cases = inputs()
            eval_raws = {c: [tpc.raw_clips(60 + i, RAW[c], valid=tpc.CASES[RAW[c]][0]),
                             tpc.raw_clips(70 + i, RAW[c], valid=1)] for i, c in enumerate(EVAL)}
            with open(tmp / "inputs.part", "wb") as f:  # each rank reads it: not copied through the spawn's pipes
                pickle.dump(dict(cases=cases, eval_raws=eval_raws), f, protocol=5)
            os.replace(tmp / "inputs.part", spec["inputs"])
            ported = pool.submit(one_process, cases, eval_raws)  # beside JAX's program
            jax_out, specs = jax_program(cases)
            one = ported.result()
            out = ranks.result()
        yield dict(cases=cases, ranks=out, jax=jax_out, specs=specs, one=one)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"/(conv|pool)_\d/bias$|/conv_map/conv/bias$", key))


@pytest.mark.parametrize("case", CASES)
def test_step_matches_jax_tp_mesh(world, case):
    got = world["ranks"][0][case]
    metrics, new_stats, grads, new = world["jax"][case]
    (step,) = got["metrics"]
    assert step.keys() == metrics.keys()
    for key, value in step.items():
        tol = 2e-3 if case in SILENCE else 0 if key == "accuracy" else 1e-4
        np.testing.assert_allclose(value, float(metrics[key]), rtol=tol, atol=1e-7 if key == "accuracy" else 0,
                                   err_msg=key)
    init_p, init_s = world["cases"][case]["init"]
    init = {k: v for k, v in tpc.flat(init_p) if k in got["params"]}  # the trained leaves
    want_g = {k: v for k, v in tpc.flat(grads) if k in init}
    want_new = {k: v for k, v in tpc.flat(new) if k in init}
    assert init.keys() == want_g.keys() == want_new.keys() == got["mu"].keys() and init
    bn = case in GENERATION
    norm = {m: np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for k, g in want_g.items()
                           if k.split("/")[0] == m)) for m in tpr.TRAINED[case]}
    sums = {m: [0.0, 0.0] for m in tpr.TRAINED[case]}
    for key, g in want_g.items():
        module = key.split("/")[0]
        gap = np.abs((got["params"][key] - init[key]) - (want_new[key] - init[key]))
        assert np.all(gap <= ptr.update_bound(1, init[key])), (key, float(gap.max() / LR))
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
    # the running averages JAX's step moves (conv_map's train-mode BN) moved as JAX's, the frozen trunk's stayed
    init_s, want_s = dict(tpc.flat(init_s)), dict(tpc.flat(new_stats))
    assert got["stats"].keys() == init_s.keys() and bool(init_s) == bn
    for key, value in got["stats"].items():
        moved = np.abs(want_s[key] - init_s[key]).max()
        if moved == 0:
            np.testing.assert_array_equal(value, init_s[key], err_msg=key)
        else:
            assert np.abs(value - want_s[key]).max() <= 1e-3 * moved, key
    assert any(np.abs(want_s[k] - init_s[k]).max() > 0 for k in want_s) == bn


@pytest.mark.parametrize("case", CASES)
def test_step_matches_one_process(world, case):
    got, one = world["ranks"][0][case]["metrics"][0], world["one"][case]
    assert got.keys() == one.keys()
    for key in one:
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_the_same_replicated_state(world, case):
    """Every rank of the grid (JAX's device order: rank r at data r // 2,
    model r % 2) the same replicated tensors, statistics and metrics bit
    for bit; the peers of each model group the same own loss terms and
    replicated gradients before the broadcast."""
    ranks = [r[case] for r in world["ranks"]]
    assert [r["grid"] for r in ranks] == [(r // TP, r % TP, N // TP, TP) for r in range(N)]
    for r in ranks[1:]:
        assert r["replicated"] == ranks[0]["replicated"] and r["metrics"] == ranks[0]["metrics"]
        for key in ranks[0]["stats"]:
            np.testing.assert_array_equal(r["stats"][key], ranks[0]["stats"][key], err_msg=key)
    for d in range(N // TP):
        assert len(ranks[TP * d]["own"]) == 1 and ranks[TP * d]["own"] == ranks[TP * d + 1]["own"], d


@pytest.mark.parametrize("case", CASES)
def test_split_kernels_are_tp_sharding_halves(world, case):
    """The generation task's 12 wide trunk convs, JAX's ``model``-axis
    leaves, held half a rank and frozen (no Adam slots); DualCamNet's none."""
    want = sorted(k for k, spec in world["specs"][case].items() if "model" in spec)
    assert len(want) == (12 if case in GENERATION else 0)
    for got in (r[case] for r in world["ranks"]):
        assert got["split_paths"] == want and got["frozen_slots"] == []
        assert 2 * got["bytes"] == got["whole_bytes"] and (got["bytes"] > 0) == bool(want)
        assert got["slot_bytes"] == got["whole_slot_bytes"] == 0


def test_music_peers_draw_the_same_permutations(world):
    """Every rank draws one process's permutations at the global clip
    count (some clip's partner sits on the other data rank), and each
    rank's prepared batch is one process's shuffled batch cut to its data
    rank's clips: the peers of a model group prepare the same batch."""
    clips, frames = tpc.CASES["music"]
    want_perms = [p.numpy() for p in tpc.music_perms(clips)]
    owner = lambda c: c // (clips // (N // TP))
    assert any(owner(int(p)) != owner(i) for i, p in enumerate(want_perms[0]))
    want = world["one"]["music batch"]
    for r, ranks in enumerate(world["ranks"]):
        got = ranks["music"]
        assert len(got["perms"]) == 1 and all(np.array_equal(a, b) for a, b in zip(got["perms"][0], want_perms))
        assert got["batch"].keys() == want.keys()
        for key, value in want.items():
            if value is None:
                assert got["batch"][key] is None, key
                continue
            mine, theirs = got["batch"][key], mesh.shard_rows(value, r // TP, N // TP)
            if value.dtype.kind == "i" or key == "correspondence":
                np.testing.assert_array_equal(mine, theirs, err_msg=key)
            else:  # the rank's rows preprocessed at its batch size, as tests/test_torch_parallel_classify.py holds them
                np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("case", GENERATION)
def test_doubled_batch_noise_is_cut_by_halves_over_the_data_group(world, case):
    """The generation task's noise for the doubled batch: one process's draw
    for the global doubled batch, of which each rank keeps its data rank's
    rows of each half; the peers of a model group the same."""
    clips, frames = tpc.CASES[RAW[case]]
    rows = 2 * clips * frames
    want = torch.randn((rows, 150), generator=step_generator(0, 0, "cpu")).numpy()
    for r, ranks in enumerate(world["ranks"]):
        d = r // TP
        np.testing.assert_array_equal(ranks[case]["eps"], np.concatenate([
            mesh.shard_rows(want[:rows // 2], d, N // TP), mesh.shard_rows(want[rows // 2:], d, N // TP)]))


@pytest.mark.parametrize("case", EVAL)
def test_evaluate_with_a_remainder_batch_matches_one_process(world, case):
    want = world["one"][f"{case} eval"]
    for r, ranks in enumerate(world["ranks"]):
        got = ranks[case]["eval"]
        assert got.keys() == want.keys() == {"cross_loss", "accuracy"}
        np.testing.assert_allclose(got["cross_loss"], want["cross_loss"], rtol=1e-5, err_msg=(case, r))
        assert got["accuracy"] == want["accuracy"], (case, r)
