"""Tensor parallelism (``parallel/mesh.py``: ``tensor_parallel=2``, two
ranks at ``(data 1, model 2)``, gloo on the CPU) for the projection, joint
and classification families, against JAX's ``Trainer(tensor_parallel=2)``
on a two-device ``(1, 2)`` CPU mesh (its state placed by ``tp_sharding``)
and against the port's one process, in f32 at full width: one step of the
projection's ``Video`` and ``Audio`` wirings and of the joint task's
default mode with ``moddrop`` and its ``onlyaudiovideo`` mode (4 one-second
clips), of the generated classifier (ResNet 1/1/1/1 under the full-width
generator, 2 clips) and of DualCamNet on real images (4 clips).

JAX splits every 4-D kernel of at least 256 output channels, frozen or not:
the frozen video VAE's 13 wide convs and the frozen audio VAE's
256-channel head in the projection and joint tasks (15, in every wiring),
the generated classifier's frozen trunk (12), nothing of DualCamNet. They
run forward only, but in the joint task's train step the gradient goes
back through the frozen split video and audio stage 2 to the trained
associator, through ``sum_input_grad``.

One spawn of two ranks (``tests/tensor_parallel_ranks.py``) runs every
port case while JAX compiles in this process: each step from the same
weights as JAX's (the port's ``init_params``, biases, BN parameters and
statistics drawn away from their initial values, carried across by
``bridge.py``) with the same noise (numpy draws at the global shape, handed
to the port as ``eps`` and ``moddrop`` and to JAX in place of its
``jax.random.normal`` and ``jax.random.uniform``), each case's state
written as a checkpoint; ``evaluate`` of the ``Video`` wiring over a
remainder batch first; after the joint ``onlyaudiovideo`` step, its video
VAE warm-started from the ``Video`` wiring's checkpoint.

Tolerances (``tests/test_torch_parallel_project.py``'s and
``test_torch_parallel_classify.py``'s, for their reasons):

- the losses and their terms within 1e-4 relative of JAX's (the audio
  encoder associator's train-mode BN, whose fast-variance cancellation
  magnifies rounding), the accuracy exact; within 1e-5 of the port's one
  process (the same f32 arithmetic, the split convs' output channels the
  same dot products and their input gradient a sum of two partial sums);
- each trained tensor's update within ``parallel_task_ranks.update_bound``
  of JAX's and of one process's, entry by entry (Adam turns a gradient at
  rounding level into a +-lr step of either sign);
- Adam's first moments (0.1 of the gradient) compared whole in L2: within
  5e-2 of JAX's a leaf (a leaf below ``LEAF_FLOOR`` of its module's
  gradient sits at rounding level and is held by its module's bound) and
  1e-3 a module; 0.5 and 5e-2 for the audio encoder associator, whose
  biases a train-mode BN follows are left out (true gradient zero). A
  gradient N times off reads |1 - N| or |1 - 1/N| there: the joint task's
  ``out_video`` and ``out_audio`` heads take their gradient from the split
  stage 2 alone, so a ``sum_input_grad`` skipped or doubled on it fails
  them;
- the BN running averages within 1e-3 of how far they moved; the frozen
  VAEs' and the frozen trunk's bit-frozen;
- the two ranks against each other bit for bit in every replicated tensor
  and in what each computed before the trainer's broadcast
  (``Trainer.own_steps``); each rank holds half of every split kernel,
  which JAX's ``tp_sharding`` puts on the ``model`` axis, and no frozen
  tensor has Adam slots;
- the checkpoint written from the grid and restored at one process, leaf
  for leaf against one process's: the same tree, the frozen leaves and
  statistics bit for bit, the trained ones as one process's within the
  update bound and bit for bit the grid's own; the warm start's video VAE
  the file's, bit for bit, each split tensor halved; ``evaluate`` against
  one process at 1e-5 relative.
"""

import concurrent.futures as cf
import dataclasses
import os
import pickle
import re
import time

import jax
import numpy as np
import pytest

import parallel_family_ranks as pfr
import parallel_task_ranks as ptr
import tensor_parallel_ranks as tpr
import test_torch_parallel_classify as tpc
import test_torch_parallel_project as tpp
from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.parallel import tp_sharding
from acoustic_image_generation_tpu.train import classify as jclassify
from acoustic_image_generation_tpu.train.joint import JointTask as JaxJoint
from acoustic_image_generation_tpu.train.project import ProjectTask as JaxProject
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, OptimConfig
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
VAES = tpp.VAES
CASES = ("project Video", "project Audio", "joint moddrop", "joint onlyaudiovideo", "classify generated",
         "classify real")
SPLIT = dict(zip(CASES, (15, 15, 15, 15, 12, 0)))  # the kernels JAX splits
WITH_BN = ("assoc_audio_enc",)  # the trained modules with a train-mode BN
LEAF_FLOOR = tpp.LEAF_FLOOR
EVALUATE, WARM = "project Video", "joint onlyaudiovideo"


def jax_cfg(case):
    """JAX's configuration of ``case``, on a ``(1, 2)`` mesh."""
    family, name = case.split()
    cfg = tpc.jax_cfg(name) if family == "classify" else tpp.jax_cfg(case)
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, num_devices=2, tensor_parallel=2))


def jax_draws(case, eps) -> list:
    """The normals JAX draws for ``case``'s step, in order (``tpp.jax_draw_order``'s)."""
    family, name = case.split()
    if family == "project":
        return [eps["latent"], eps["latent"], eps["triplet"]]
    if family == "joint":
        return [eps["acoustic"]] if name == "onlyaudiovideo" else [eps[k] for k in ("acoustic", "video", "audio")]
    return [] if eps is None else [eps]


def jax_program(cases: dict):
    """Each case's Trainer at ``tensor_parallel=2`` on its ``(1, 2)`` mesh,
    the trees placed by ``tp_sharding`` (the VAEs, which the projection and
    joint cases share, go in once): ``({case: (metrics, new batch_stats,
    gradient of the trained modules, the trained modules after one step of
    the Trainer's TF1 Adam)}, {case: flat partition specs})``."""
    tasks, trainers = {}, {}
    for case in CASES:
        family, name = case.split()
        make = {"project": JaxProject, "joint": JaxJoint}.get(family) or tpc.JAX_TASK.get(
            name, jclassify.ClassificationTask)
        tasks[case] = make(jax_cfg(case))
        trainers[case] = JaxTrainer(tasks[case], jax_cfg(case))
    grid = trainers[CASES[0]].mesh
    assert dict(grid.shape) == {"data": 1, "model": 2}
    vaes = tuple({k: cases[CASES[0]]["init"][i][k] for k in VAES if k in cases[CASES[0]]["init"][i]} for i in (0, 1))
    own = {c: tuple({k: v for k, v in cases[c]["init"][i].items() if k not in VAES} for i in (0, 1)) for c in CASES}

    def program(vaes, own, device_raws):
        out = {}
        for case in CASES:
            rngs = jrng.train_step_rngs(trainers[case].base_key, 0)
            batch = trainers[case]._prepare(device_raws[case], key=rngs["data"])
            vae = vaes if case.split()[0] in ("project", "joint") else ({}, {})
            params, stats = {**vae[0], **own[case][0]}, {**vae[1], **own[case][1]}

            def loss(p, case=case, params=params, stats=stats, batch=batch, rngs=rngs):
                total, metrics, new_stats = tasks[case].loss(dict(params, **p), stats, batch, rngs, train=True)
                return total, (metrics, new_stats)

            wrt = {k: params[k] for k in tpr.TRAINED[case]}
            (_, (metrics, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(wrt)
            out[case] = (metrics, new_stats, grads)
        return out

    device_raws = {c: trainers[c].device_batch(JaxRawBatch(*(cases[c]["raw"][k] for k in (
        "acoustic", "audio", "video", "action", "location")), cases[c]["raw"]["audio"].shape[0])) for c in CASES}
    place = lambda tree: jax.device_put(tree, tp_sharding(tree, grid))
    specs = {c: dict(tpp.flat(jax.tree_util.tree_map(lambda s: tuple(s.spec), tp_sharding(
        {**(vaes[0] if c.split()[0] in ("project", "joint") else {}), **own[c][0]}, grid)))) for c in CASES}
    normals = [d for c in CASES for d in jax_draws(c, cases[c]["eps"])]
    with tpp.jax_draws(normals, tpp.MODDROP_UNIFORM):
        out = jax.device_get(jax.jit(program)(place(vaes), place(own), device_raws))
    # the trained modules after one step of the Trainer's optimizer (TF1 Adam), every case in one program
    trained = {c: {k: cases[c]["init"][0][k] for k in tpr.TRAINED[c]} for c in CASES}
    new = tpp.adam_step(trained, {c: out[c][2] for c in CASES})
    return {c: (*out[c], new[c]) for c in CASES}, specs


def inputs():
    """Each case's flax trees, global batch and noise: the projection's and
    the joint task's as ``test_torch_parallel_project.py`` makes them (its
    VAE trees shared by the four cases), the classification cases' as
    ``test_torch_parallel_classify.py`` does."""
    p_init, j_init = tpp.inits()
    p_eps, j_eps = tpp.noise()
    raw = tpp.raw_clips(10)
    cases = {"project Video": dict(init=p_init["Video"], raw=raw, eps=p_eps),
             "project Audio": dict(init=p_init["Audio"], raw=raw, eps=p_eps),
             "joint moddrop": dict(init=j_init["moddrop"], raw=raw, eps=j_eps,
                                   moddrop=float(tpp.MODDROP_UNIFORM < 0.2)),
             "joint onlyaudiovideo": dict(init=j_init["onlyaudiovideo"], raw=raw, eps={"acoustic": j_eps["acoustic"]})}
    rng = np.random.default_rng(2)
    for i, name in enumerate(("generated", "real")):
        init = tuple(perturb(t, rng) for t in bridge.to_flax(pfr.classify_task(name)))
        clips, frames = tpc.CASES[name]
        eps = rng.standard_normal((clips * frames, 150)).astype(np.float32) if name == "generated" else None
        cases[f"classify {name}"] = dict(init=init, raw=tpc.raw_clips(20 + i, name), eps=eps)
    return cases


_VAE_MODULES = {}  # the one process's frozen VAE modules, shared by its projection and joint tasks


def one_task(case, init):
    """The one process's task of ``case``, its frozen VAEs the modules the
    first such case loaded (a gigabyte; a restored checkpoint writes them
    again, bit for bit or the comparison fails)."""
    if not case.startswith(("project", "joint")):
        return tpr.case_task(case, init)
    task = tpr.case_task(case, None)
    params, stats = init
    for name, module in task.named_children():
        if name in _VAE_MODULES:
            setattr(task, name, _VAE_MODULES[name])
            continue
        bridge.load_flax(module, params[name], stats.get(name, {}))
        if name in VAES:
            _VAE_MODULES[name] = module
    return task


def one_process(cases: dict, eval_raws: list) -> dict:
    """The port's one-process step of each case from the same weights and
    noise (its state dict, as its checkpoint would hold it, and its
    trainer), and ``evaluate`` of the ``Video`` wiring over the remainder
    batches."""
    out = {}
    for case in CASES:
        c = cases[case]
        trainer = Trainer(one_task(case, c["init"]), ExperimentConfig(optim=OptimConfig(learning_rate=LR)))
        state = trainer.init_state()
        if case == EVALUATE:
            out["eval"] = trainer.evaluate(state, tpp.GlobalLoader(eval_raws), use_cache=False)
        state, m = trainer.train_step(state, c["raw"], eps=c["eps"], moddrop=c.get("moddrop"))
        out[case] = dict(metrics={k: float(v) for k, v in m.items()}, sd=small(ckpt.state_dict(state), c["init"][0]),
                         trainer=trainer, state=state)
    return out


def small(sd: dict, init_params: dict) -> dict:
    """A state dict whose frozen VAEs' parameters (a gigabyte) are replaced
    by their shapes, and ``vae_equal``: whether each VAE's tree is
    ``init_params``' bit for bit."""
    params = {k: v for k, v in sd["params"].items() if k not in VAES}
    vaes = {k: sd["params"][k] for k in VAES if k in sd["params"]}
    shapes = jax.tree_util.tree_map(lambda a: np.asarray(a).shape, vaes)
    return dict(sd, params=params, vae_shapes=shapes, vae_equal={k: tpr.trees_equal(v, init_params[k])
                                                                  for k, v in vaes.items()})


def restore_as_written(one: dict, cases: dict, run_dir: str, ranks) -> dict:
    """Each grid checkpoint restored at one process (into the one process's
    trainer of the case) as soon as the ranks have written it, then
    deleted, but the first, which the ranks read again for their warm
    start."""
    restored = {}
    for case in CASES:
        path = f"{run_dir}/tp/epoch_{tpr.ckpt_name(case)}.ckpt"
        while not os.path.exists(path):
            if ranks.done():
                ranks.result()  # a rank's error
                raise AssertionError(f"the ranks wrote no {path}")
            time.sleep(0.2)
        state = one[case].pop("trainer").restore(path, one[case].pop("state"))
        restored[case] = small(ckpt.state_dict(state), cases[case]["init"][0])
        if case != CASES[0]:
            os.remove(path)
    return restored


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawn of two ranks (in a thread), the inputs, which they read
    from a file, JAX's program, and beside it (in another thread) the one
    process's steps and the grid's checkpoints restored there."""
    with module_dir(tmp_path_factory, "tensor_parallel_families", need_mb=4000) as tmp:  # 1.1 GB checkpoints
        spec = dict(inputs=str(tmp / "inputs.pkl"), evaluate=EVALUATE, warm=WARM, run_dir=str(tmp / "runs"))
        with cf.ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(mesh.launch, tpr.family_cases, 2, spec, device="cpu", tmp_dir=str(tmp))
            cases = inputs()
            eval_raws = [dict(tpp.raw_clips(11, 2, np.array([0, 1], np.int32)), valid=2),
                         dict(tpp.raw_clips(12, 2, np.array([1, 1], np.int32)), valid=1)]
            with open(tmp / "inputs.part", "wb") as f:  # each rank reads it: not copied through the spawn's pipes
                pickle.dump(dict(cases=cases, eval_raws=eval_raws), f, protocol=5)
            os.replace(tmp / "inputs.part", spec["inputs"])

            def port_one_process():
                one = one_process(cases, eval_raws)
                return one, restore_as_written(one, cases, spec["run_dir"], ranks)

            ported = pool.submit(port_one_process)  # beside JAX's program, in this thread
            jax_out, specs = jax_program(cases)
            one, restored = ported.result()
            out = ranks.result()
        _VAE_MODULES.clear()
        yield dict(cases=cases, ranks=out, jax=jax_out, specs=specs, one=one, restored=restored)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"/layer\d+/(conv|pool)_\d/bias$", key))


def first_moment_gaps(got_mu: dict, grads: dict, trained: tuple) -> tuple[dict, dict]:
    """Adam's first moments (0.1 of the gradient) against JAX's gradient in
    L2: ``({leaf: gap}, {module: gap})``, the leaves at rounding level
    (below LEAF_FLOOR of their module's gradient) and the BN-cancelled
    biases left out of the first."""
    want = dict(tpp.flat(grads))
    norm = {m: np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for k, g in want.items()
                           if k.split("/")[0] == m)) for m in trained}
    leaves, sums = {}, {m: [0.0, 0.0] for m in trained}
    for key, g in want.items():
        module = key.split("/")[0]
        if module in WITH_BN and bn_cancelled(key):
            continue
        mine = got_mu[key].astype(np.float64) / 0.1
        sums[module][0] += float(np.sum((mine - g) ** 2))
        sums[module][1] += float(np.sum(np.asarray(g, np.float64) ** 2))
        if np.linalg.norm(g) >= LEAF_FLOOR * norm[module]:
            leaves[key] = rel_l2(mine, g)
    return leaves, {m: float(np.sqrt(num / den)) for m, (num, den) in sums.items() if den}


@pytest.mark.parametrize("case", CASES)
def test_step_matches_jax_tp_mesh(world, case):
    got = world["ranks"][0][case]
    metrics, new_stats, grads, new = world["jax"][case]
    (step,) = got["metrics"]
    assert step.keys() == metrics.keys()
    for key, value in step.items():
        exact = key == "accuracy"
        np.testing.assert_allclose(value, float(metrics[key]), rtol=0 if exact else 1e-4, atol=1e-7 if exact else 0,
                                   err_msg=key)
    init_p, init_s = world["cases"][case]["init"]
    trained = {k: init_p[k] for k in tpr.TRAINED[case]}
    init, want_new = dict(tpp.flat(trained)), dict(tpp.flat(new))
    assert got["params"].keys() == want_new.keys() == got["mu"].keys() and want_new
    for key, value in got["params"].items():
        gap = np.abs((value - init[key]) - (want_new[key] - init[key]))
        assert np.all(gap <= ptr.update_bound(1, init[key])), (key, float(gap.max() / LR))
    leaves, modules = first_moment_gaps(got["mu"], grads, tpr.TRAINED[case])
    for key, gap in leaves.items():
        assert gap <= (0.5 if key.split("/")[0] in WITH_BN else 5e-2), (key, gap)
    for module, gap in modules.items():
        assert gap <= (5e-2 if module in WITH_BN else 1e-3), (module, gap)
    # running averages: a trained module's train-mode BN moved as JAX's, the frozen ones stayed
    init_s, want_s = dict(tpp.flat(init_s)), dict(tpp.flat(new_stats))
    assert got["stats"].keys() == init_s.keys()
    for key, value in got["stats"].items():
        if key.split("/")[0] in WITH_BN:
            moved = np.abs(want_s[key] - init_s[key]).max()
            assert moved > 0 and np.abs(value - want_s[key]).max() <= 1e-3 * moved, key
        else:
            np.testing.assert_array_equal(value, init_s[key], err_msg=key)


def test_joint_frozen_split_stage_2_passes_the_whole_input_gradient(world):
    """The joint task's associator heads ``out_video`` and ``out_audio``
    take their whole gradient through the frozen split stage 2 (the video
    VAE's head and decoder, the audio VAE's head), summed over the model
    group once: their first moments are JAX's within 5e-2 in L2, where a
    skipped or a doubled sum reads 0.5 or more."""
    got = world["ranks"][0]["joint moddrop"]
    grads = world["jax"]["joint moddrop"][2]
    want = dict(tpp.flat(grads))
    for head in ("out_video", "out_audio"):
        keys = [k for k in want if k.startswith(f"associator/{head}/")]
        assert len(keys) == 2
        mine = np.concatenate([got["mu"][k].ravel() / 0.1 for k in keys])
        theirs = np.concatenate([np.asarray(want[k]).ravel() for k in keys])
        assert rel_l2(mine, theirs) <= 5e-2, (head, rel_l2(mine, theirs))


@pytest.mark.parametrize("case", CASES)
def test_step_matches_one_process(world, case):
    got, one = world["ranks"][0][case]["metrics"][0], world["one"][case]["metrics"]
    assert got.keys() == one.keys()
    for key in one:
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_peers_hold_the_same_replicated_state(world, case):
    a, b = (world["ranks"][r][case] for r in (0, 1))
    assert a["grid"] == (0, 0, 1, 2) and b["grid"] == (0, 1, 1, 2)
    assert a["replicated"] == b["replicated"] and a["metrics"] == b["metrics"]
    assert len(a["own"]) == 1 and a["own"] == b["own"]
    for key in a["stats"]:
        np.testing.assert_array_equal(a["stats"][key], b["stats"][key], err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_split_kernels_are_tp_sharding_halves_without_slots(world, case):
    """The kernels the port splits are those JAX's ``tp_sharding`` puts on
    the ``model`` axis, frozen ones included; each rank holds half of each,
    and no frozen tensor (split or whole) has Adam slots."""
    want = sorted(k for k, spec in world["specs"][case].items() if "model" in spec)
    assert len(want) == SPLIT[case]
    for r in (0, 1):
        got = world["ranks"][r][case]
        assert got["split_paths"] == want and len(got["split"]) == len(want) and got["frozen_slots"] == []
        if not want:
            assert got["bytes"] == got["whole_bytes"] == 0
            continue
        assert 2 * got["bytes"] == got["whole_bytes"] > 0
        assert got["slot_bytes"] == got["whole_slot_bytes"] == 0  # every split kernel here is frozen


@pytest.mark.parametrize("case", CASES)
def test_checkpoint_from_the_grid_restores_at_one_process(world, case):
    """The grid's checkpoint (split tensors gathered whole, rank 0 writing
    JAX's file) restored at one process, leaf for leaf against one
    process's own state dict: the same tree; the frozen VAEs' and trunk's
    leaves bit for bit; the trained leaves, their first moments and the
    statistics the grid's own bit for bit, the trained leaves one
    process's within the update bound, the train-mode BN's running
    averages within 1e-3 of how far they moved, the frozen ones bit for
    bit."""
    got, one, grid = world["restored"][case], world["one"][case]["sd"], world["ranks"][0][case]
    shape = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a).shape, tree)
    assert shape({k: v for k, v in got.items() if k != "vae_equal"}) == shape(
        {k: v for k, v in one.items() if k != "vae_equal"})
    assert int(got["step"]) == int(one["step"]) == 1
    assert all(got["vae_equal"].values()) and all(one["vae_equal"].values())
    assert bool(got["vae_equal"]) == case.startswith(("project", "joint"))
    labelled = "inner_states" in got["opt_state"]
    adam = lambda sd: (sd["opt_state"]["inner_states"]["train"]["inner_state"] if labelled else sd["opt_state"])["0"]
    mine, theirs = dict(tpp.flat(got["params"])), dict(tpp.flat(one["params"]))
    mu, mu_one = dict(tpp.flat(adam(got)["mu"])), dict(tpp.flat(adam(one)["mu"]))
    init = dict(tpp.flat(world["cases"][case]["init"][0]))
    for key, value in mine.items():
        if key.split("/")[0] not in tpr.TRAINED[case]:
            np.testing.assert_array_equal(value, theirs[key], err_msg=key)
            continue
        np.testing.assert_array_equal(ptr.sampled(value), grid["params"][key], err_msg=key)
        np.testing.assert_array_equal(ptr.sampled(mu[key]), grid["mu"][key], err_msg=key)
        gap = np.abs(value - theirs[key])
        assert np.all(gap <= ptr.update_bound(1, init[key])), (key, float(gap.max() / LR))
        assert mu_one[key].shape == mu[key].shape, key
    stats, stats_one = dict(tpp.flat(got["batch_stats"])), dict(tpp.flat(one["batch_stats"]))
    init_s = dict(tpp.flat(world["cases"][case]["init"][1]))
    assert stats.keys() == stats_one.keys() == grid["stats"].keys()
    for key, value in stats.items():
        np.testing.assert_array_equal(value, grid["stats"][key], err_msg=key)
        if key.split("/")[0] in WITH_BN:
            moved = np.abs(stats_one[key] - init_s[key]).max()
            assert moved > 0 and np.abs(value - stats_one[key]).max() <= 1e-3 * moved, key
        else:
            np.testing.assert_array_equal(value, stats_one[key], err_msg=key)


def test_evaluate_with_a_remainder_batch_matches_one_process(world):
    want = world["one"]["eval"]
    for r in (0, 1):
        got = world["ranks"][r][EVALUATE]["eval"]
        assert got.keys() == want.keys() == {"mse"}
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5, err_msg=r)


def test_warm_start_of_the_vaes_lands_split(world):
    """The joint ``onlyaudiovideo`` case's VAEs, zeroed on the grid, warm
    started from the projection's whole checkpoint before its step: each
    rank holds half of every split kernel, and the video VAE gathered whole
    is the file's (the step that follows matches JAX's and one process's
    from the same weights)."""
    want = {n: tuple(s) for n, (s, _) in world["ranks"][0][EVALUATE]["split"].items() if n.startswith("video.")}
    assert len(want) == 13
    for r in (0, 1):
        warm = world["ranks"][r][WARM]["warm"]
        assert {f"video.{n}": s for n, (s, _) in warm["split"].items()} == want and warm["equal"]
