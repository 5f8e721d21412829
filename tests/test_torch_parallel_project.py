"""The projection and joint tasks on two ranks (``parallel/mesh.py``: one
process a device, gloo on the CPU) against JAX's one program over a
two-device CPU mesh, in f32 at full width: one step of a 4-second global
batch (2 seconds a rank) whose labels 0, 1, 1, 0 put each label on both
ranks, so that the projection's batch-hard triplet mining pairs rows across
them.

One spawn of two ranks (``tests/parallel_family_ranks.py``) runs every port
case while JAX compiles in this process: a step of each projection wiring
(``Audio``, ``Video``, ``fusion``, ``l2``) and each joint mode (default,
``fusion``, ``moddrop``, ``onlyaudiovideo``) under DDP; the ``Audio``
wiring and the default joint mode under FSDP, the former's state written
and restored at one process; the ``Audio`` wiring and the ``moddrop`` mode
with the noise the trainer draws (without a step of its own); ``evaluate`` of
the ``Audio`` wiring over a remainder batch. The same weights (the port's ``init_params(0)`` of the
VAEs and associators, biases, BN parameters and statistics drawn away from
their initial values) and the same noise (numpy draws at the global shape
handed to the port as ``eps``, and to JAX in place of its
``jax.random.normal`` in the order it draws; the moddrop uniform that drops
the acoustic map) go into both. JAX's side is one jitted program on its
``Trainer``'s mesh (its ``device_batch`` shards the global batch, its
``_prepare`` and step keys make the batch) that returns each case's loss,
metrics, new BN statistics and the gradient of the trained associator;
its TF1 Adam (``adam_tf1``, the Trainer's optimizer) takes the step.

Tolerances (``tests/test_torch_parallel_reconstruct.py``'s, and why):

- the losses and each term within 1e-4 relative (the audio encoder
  associator's train-mode BN, whose fast-variance cancellation magnifies
  rounding);
- each trained tensor's update within 2 lr entry by entry
  (``parallel_task_ranks.update_bound``: Adam turns a gradient at rounding
  level into a +-lr step of either sign; the video associator's biases hold
  entries near TF1 Adam's epsilon, where a rounding-level gap moves the
  step by a share of lr, so the tighter trajectory bounds are not held);
- Adam's first moments (0.1 of the gradient, which the update cannot show:
  a gradient N times too large or too small reads |1 - N| or |1 - 1/N|
  here) in L2, within 5e-2 of JAX's a leaf and 1e-3 over the associator
  without BN; within 0.5 a leaf and 5e-2 over it for the audio encoder
  associator, the biases that a train-mode BN follows left out (true
  gradient zero), as the BN VAEs of the reconstruction test. The leaf
  bounds skip a leaf whose gradient is below ``LEAF_FLOOR`` of its
  module's: there one process differs from JAX as much as two ranks do;
- the audio encoder associator's running averages within 1e-3 of how far
  they moved; the frozen VAEs' statistics bit-frozen;
- the two ranks against each other, the drawn noise against one process's
  draws cut to the rank's rows, and the checkpoint restored at one process:
  bit for bit; ``evaluate`` against one process at 1e-5 relative (the same
  f32 arithmetic summed in another order).
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
from acoustic_image_generation_tpu.parallel import fsdp_sharding, make_mesh
from acoustic_image_generation_tpu.train.joint import JointTask as JaxJoint
from acoustic_image_generation_tpu.train.optim import adam_tf1
from acoustic_image_generation_tpu.train.project import ProjectTask as JaxProject
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.associators import JOINT_HEADS, AssociatorAudioEncoder, JointMVAE
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, step_generator
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = ptr.LR
SECONDS = 4
ACTIONS = np.array([0, 1, 1, 0], np.int32)  # rank 0 holds 0, 1; rank 1 holds 1, 0
MODDROP_UNIFORM = 0.5  # >= 0.2: the moddrop step drops the acoustic map
VAES = ("acoustic", "video", "audio")
TRAINED = {**{f"project {w}": ("assoc_audio_enc",) if w == "Audio" else
              ("assoc_video", "assoc_audio") if w == "fusion" else ("assoc_video",) for w in pfr.PROJECT},
           **{f"joint {m}": ("associator1",) if m == "onlyaudiovideo" else ("associator",) for m in pfr.JOINT}}
WITH_BN = ("assoc_audio_enc",)
# a leaf whose gradient is below this share of its module's (in L2) sits at the module's rounding level: one
# process and JAX differ by 0.75 in L2 on the video associator's mean_3 and mean_4 biases (1e-6 against the
# kernels' 7e-3), two ranks and one process by 0.47; such a leaf is held by its module's L2 alone
LEAF_FLOOR = 1e-3


def raw_clips(seed, seconds=SECONDS, actions=ACTIONS):
    rng = np.random.default_rng(seed)
    f = (seconds, 12)
    return dict(acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
                audio=rng.integers(-(2**15), 2**15, (*f, 1024)).astype(np.int32),
                video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
                action=actions, location=np.zeros(seconds, np.int32))


def jax_cfg(case):
    family, name = case.split()
    model = dict(project=True, **pfr.PROJECT[name]) if family == "project" else dict(jointmvae=True,
                                                                                    **pfr.JOINT[name])
    return ExperimentConfig(data=DataConfig(batch_size=SECONDS, sample_length=1),
                            model=ModelConfig(embedding=True, **model), optim=OptimConfig(learning_rate=LR),
                            run=RunConfig(checkpoint_dir="unused"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=2))


def flax_of(module, seed: int, rng) -> tuple[dict, dict]:
    init_modules(module, seed)
    return tuple(perturb(t, rng) for t in bridge.to_flax(module))


def inits():
    """The flax trees of each case: the VAEs and associators of the port's
    ``init_params``, perturbed; every case shares the VAEs' arrays."""
    rng = np.random.default_rng(1)
    task = ProjectTask(ProjectConfig(fusion=True, compute_dtype="float32"), device="cpu").init_params(0)
    params, stats = (perturb(t, rng) for t in bridge.to_flax(task))
    del task
    enc = flax_of(AssociatorAudioEncoder(), 1, rng)
    pair = JOINT_HEADS["video"] + JOINT_HEADS["audio"]
    assoc = {"three": flax_of(JointMVAE(JOINT_HEADS["ac"] + pair), 2, rng)[0],
             "two": flax_of(JointMVAE(pair), 3, rng)[0], "ac": flax_of(JointMVAE(pair, heads=("ac",)), 4, rng)[0]}
    vae_p = {k: params[k] for k in VAES}
    vae_s = {k: stats[k] for k in VAES if k in stats}
    project = {"Audio": ({**vae_p, "assoc_audio_enc": enc[0]}, {**vae_s, "assoc_audio_enc": enc[1]}),
               "Video": ({**vae_p, "assoc_video": params["assoc_video"]}, vae_s),
               "fusion": ({**vae_p, "assoc_video": params["assoc_video"], "assoc_audio": params["assoc_audio"]},
                          vae_s)}
    project["l2"] = project["Video"]
    joint = {"default": ({**vae_p, "associator": assoc["three"]}, vae_s),
             "fusion": ({**vae_p, "associator": assoc["two"]}, vae_s),
             "onlyaudiovideo": ({**vae_p, "associator": assoc["three"], "associator1": assoc["ac"]}, vae_s)}
    joint["moddrop"] = joint["default"]
    return project, joint


def noise():
    """Numpy draws at the global shape: the projection's ``latent`` and
    ``triplet``, the joint task's stage-2 ``acoustic``, ``video`` and
    ``audio``."""
    rng = np.random.default_rng(5)
    draw = lambda d: rng.standard_normal((SECONDS, d)).astype(np.float32)
    project = {"latent": draw(150), "triplet": draw(150)}
    joint = {"acoustic": draw(150), "video": draw(1024), "audio": draw(256)}
    return project, joint


@contextlib.contextmanager
def jax_draws(draws: list, uniform: float):
    """JAX's ``jax.random.normal`` returns ``draws`` in order (each of its
    call's shape) and its ``jax.random.uniform`` ``uniform``: constants of
    the traced program."""
    normal, uniform_fn = jax.random.normal, jax.random.uniform
    queue = iter(draws)

    def fixed_normal(key, shape, dtype=jnp.float32):
        value = next(queue)
        assert tuple(shape) == value.shape, (shape, value.shape)
        return jnp.asarray(value, dtype)

    def fixed_uniform(key, shape=(), dtype=jnp.float32, *args, **kw):
        assert tuple(shape) == (1,), shape
        return jnp.full(shape, uniform, dtype)

    jax.random.normal, jax.random.uniform = fixed_normal, fixed_uniform
    try:
        yield
        assert next(queue, None) is None, "JAX drew fewer normals than handed in"
    finally:
        jax.random.normal, jax.random.uniform = normal, uniform_fn


def jax_draw_order(p_eps, j_eps) -> list:
    """The normals JAX draws while tracing ``jax_program``, in order: a
    projection step draws its acoustic VAE's own sample (unread: the
    translated latent replaces it), the translated latent's and, without
    ``l2``, the triplet's; a joint step its stage-2 noise."""
    order = []
    for wiring in pfr.PROJECT:
        order += [p_eps["latent"], p_eps["latent"]] + ([] if wiring == "l2" else [p_eps["triplet"]])
    for mode in pfr.JOINT:
        order += [j_eps["acoustic"]] if mode == "onlyaudiovideo" else [j_eps[k] for k in ("acoustic", "video",
                                                                                         "audio")]
    return order


def jax_program(inits_, raw, p_eps, j_eps):
    """JAX's program on its Trainer's two-device mesh: ``{case: (metrics,
    new batch_stats, gradient of the trained modules)}``. The VAEs' trees,
    which every case shares, go in once."""
    cases = [f"project {w}" for w in pfr.PROJECT] + [f"joint {m}" for m in pfr.JOINT]
    tasks = {c: (JaxProject if c.startswith("project") else JaxJoint)(jax_cfg(c)) for c in cases}
    jtr = JaxTrainer(tasks["project Audio"], jax_cfg("project Audio"))
    vae_p, vae_s = inits_[1]["default"]
    own = {}
    for c in cases:
        params, stats = inits_[0 if c.startswith("project") else 1][c.split()[1]]
        own[c] = ({k: v for k, v in params.items() if k not in VAES}, {k: v for k, v in stats.items() if k not in VAES})

    def program(vaes, own, device_raw):
        rngs = jrng.train_step_rngs(jtr.base_key, 0)
        batch = jtr._prepare(device_raw, key=rngs["data"])
        out = {}
        for case in cases:
            params, stats = {**vaes[0], **own[case][0]}, {**vaes[1], **own[case][1]}

            def loss(p, case=case, params=params, stats=stats):
                total, metrics, new_stats = tasks[case].loss(dict(params, **p), stats, batch, rngs, train=True)
                return total, (metrics, new_stats)

            wrt = {k: params[k] for k in TRAINED[case]}
            (_, (metrics, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(wrt)
            out[case] = (metrics, new_stats, grads)
        return out

    device_raw = jtr.device_batch(JaxRawBatch(raw["acoustic"], raw["audio"], raw["video"], raw["action"],
                                              raw["location"], SECONDS))
    put = lambda t: jax.device_put(t, jtr._replicated)
    with jax_draws(jax_draw_order(p_eps, j_eps), MODDROP_UNIFORM):
        return jax.device_get(jax.jit(program)(put((vae_p, vae_s)), put(own), device_raw))


def adam_step(params: dict, grads: dict) -> dict:
    """The parameters after one step of JAX's Trainer's optimizer (TF1
    Adam) from ``grads``."""
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the spawn of two ranks (in a thread), JAX's program, the
    one-process evaluation and the restored checkpoint."""
    with module_dir(tmp_path_factory, "parallel_project", need_mb=2500) as tmp:  # a 1 GB checkpoint, the pickles
        inits_ = inits()
        p_eps, j_eps = noise()
        raw = raw_clips(10)
        eval_raws = [dict(raw_clips(11, 2, np.array([0, 1], np.int32)), valid=2),
                     dict(raw_clips(12, 2, np.array([1, 1], np.int32)), valid=1)]
        spec = dict(raw=raw, project_init=inits_[0], joint_init=inits_[1], moddrop=float(MODDROP_UNIFORM < 0.2),
                    project_eps={w: p_eps if w != "l2" else {"latent": p_eps["latent"]} for w in pfr.PROJECT},
                    joint_eps={m: j_eps if m != "onlyaudiovideo" else {"acoustic": j_eps["acoustic"]}
                               for m in pfr.JOINT},
                    eval_raws=eval_raws, run_dir=str(tmp / "runs"))
        with cf.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(mesh.launch, pfr.project_cases, 2, spec, device="cpu", tmp_dir=str(tmp))
            jax_out = jax_program((inits_[0], inits_[1]), raw, p_eps, j_eps)
            specs = {c: dict(flat(jax.tree_util.tree_map(lambda s: tuple(s.spec), fsdp_sharding(
                {k: inits_[i][name][0][k] for k in TRAINED[c]}, make_mesh(2)))))
                for c, i, name in (("project Audio", 0, "Audio"), ("joint default", 1, "default"))}
            # one process: evaluate over the same batches, and the FSDP run's checkpoint restored
            trainer = Trainer(pfr.project_task("Audio", inits_[0]["Audio"]))
            one_eval = trainer.evaluate(trainer.init_state(), GlobalLoader(eval_raws), use_cache=False)
            out = ranks.result()
            sd = ckpt.state_dict(trainer.restore(f"{spec['run_dir']}/par/epoch_final.ckpt", trainer.init_state()))
            mu = sd["opt_state"]["inner_states"]["train"]["inner_state"]["0"]["mu"]
            restored = dict(step=int(sd["step"]), mu=dict(flat(mu)), params=dict(flat(sd["params"])),
                            stats=dict(flat(sd["batch_stats"])))
            del trainer
        yield dict(spec=spec, inits=inits_, eps=(p_eps, j_eps), ranks=out, jax=jax_out, jax_specs=specs,
                   one_eval=one_eval, restored=restored)


class GlobalLoader:
    """One process's loader of the global batches (dicts with ``valid``)."""

    def __init__(self, raws):
        self.raws = raws

    def batches(self, epoch=0):
        yield from self.raws


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"/layer\d+/(conv|pool)_\d/bias$", key))


JAX_CASE = {"project Audio fsdp": "project Audio", "joint default fsdp": "joint default"}
CHECKED = [*TRAINED, *JAX_CASE]


@pytest.mark.parametrize("case", CHECKED)
def test_ranks_match_jax_mesh(world, case):
    got = world["ranks"][0][case]
    jcase = JAX_CASE.get(case, case)
    metrics, new_stats, grads = world["jax"][jcase]
    (step,) = got["metrics"]
    assert step.keys() == metrics.keys()
    for name, value in step.items():
        np.testing.assert_allclose(value, float(metrics[name]), rtol=1e-4, err_msg=name)
    if "triplet" in step:
        assert step["triplet"] > 0
    family, name = jcase.split()
    params, stats = world["inits"][0 if family == "project" else 1][name]
    trained = {k: params[k] for k in TRAINED[jcase]}
    init, want_new = dict(flat(trained)), dict(flat(adam_step(trained, grads)))
    want_g = dict(flat(grads))
    assert got["params"].keys() == want_new.keys() == got["mu"].keys()
    norm = {m: np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for k, g in want_g.items()
                           if k.split("/")[0] == m)) for m in trained}
    sums = {m: [0.0, 0.0] for m in trained}
    for key, g in want_g.items():
        module = key.split("/")[0]
        bn = module in WITH_BN
        gap = np.abs((got["params"][key] - init[key]) - (want_new[key] - init[key]))
        assert np.all(gap <= ptr.update_bound(1, init[key])), (key, float(gap.max() / LR))
        if bn and bn_cancelled(key):
            continue
        mine = got["mu"][key].astype(np.float64) / 0.1
        sums[module][0] += float(np.sum((mine - g) ** 2))
        sums[module][1] += float(np.sum(np.asarray(g, np.float64) ** 2))
        if np.linalg.norm(g) < LEAF_FLOOR * norm[module]:
            continue  # at the module's rounding level: held by the module's L2 below
        assert rel_l2(mine, g) <= (0.5 if bn else 5e-2), (key, rel_l2(mine, g))
    for module, (num, den) in sums.items():
        assert np.sqrt(num / den) <= (5e-2 if module in WITH_BN else 1e-3), (module, float(np.sqrt(num / den)))
    # running averages: the audio encoder associator's moved as JAX's, the frozen VAEs' stayed
    init_s, want_s = dict(flat(stats)), dict(flat(new_stats))
    assert got["stats"].keys() == init_s.keys()
    for key, value in got["stats"].items():
        if key.split("/")[0] in WITH_BN:
            moved = np.abs(want_s[key] - init_s[key]).max()
            assert moved > 0 and np.abs(value - want_s[key]).max() <= 1e-3 * moved, key
        else:
            np.testing.assert_array_equal(value, init_s[key], err_msg=key)


@pytest.mark.parametrize("case", CHECKED)
def test_ranks_hold_the_same_state_and_metrics(world, case):
    a, b = (world["ranks"][r][case] for r in (0, 1))
    assert a["digest"] == b["digest"] and a["metrics"] == b["metrics"]


def test_the_global_batch_puts_each_label_on_both_ranks(world):
    halves = [set(mesh.shard_rows(ACTIONS, r, 2)) for r in (0, 1)]
    assert halves[0] == halves[1] == {0, 1}
    assert world["spec"]["moddrop"] == 0.0


@pytest.mark.parametrize("case", ["project Audio fsdp", "joint default fsdp"])
def test_fsdp_shards_as_jax(world, case):
    """The trained leaves JAX's ``fsdp_sharding`` shards are the ones FSDP
    shards, and the Adam moments with them."""
    got, ddp = world["ranks"][0][case], world["ranks"][0][JAX_CASE[case]]
    specs = world["jax_specs"][JAX_CASE[case]]
    name, module = {"project Audio fsdp": ("assoc_audio_enc", AssociatorAudioEncoder()),
                    "joint default fsdp": ("associator", JointMVAE(sum(JOINT_HEADS.values())))}[case]
    name_of = {id(p): f"{name}.{n}" for n, p in module.named_parameters()}
    want = sorted(name_of[id(t)] for t, coll, path, _ in bridge.targets(module)
                  if coll == "params" and any(a is not None for a in specs["/".join((name, *path))]))
    assert got["sharded"] == want and want
    assert ddp["sharded"] == [] and got["moments"] < 0.75 * ddp["moments"]


@pytest.mark.parametrize("case", ["project Audio", "joint moddrop"])
def test_drawn_noise_is_one_process_draw_cut_to_the_rank(world, case):
    """With no noise handed in, each rank's step noise is the draw one
    process makes for the global batch (the moddrop flag first, whole on
    every rank; then each per-row draw), cut to the rank's rows."""
    g = step_generator(0, 0, "cpu")
    if case.startswith("project"):
        want = {k: torch.randn((SECONDS, 150), generator=g).numpy() for k in ("latent", "triplet")}
    else:
        want = {"moddrop": (torch.rand((1,), generator=g) < 0.2).float().numpy()}
        want.update({k: torch.randn((SECONDS, d), generator=g).numpy()
                     for k, d in (("acoustic", 150), ("video", 1024), ("audio", 256))})
    for r in (0, 1):
        got = world["ranks"][r][case]["eps"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v if k == "moddrop" else mesh.shard_rows(v, r, 2), err_msg=k)


def test_evaluate_with_a_remainder_batch_matches_one_process(world):
    want = world["one_eval"]
    for r in (0, 1):
        got = world["ranks"][r]["project Audio"]["eval"]
        assert got.keys() == want.keys() == {"mse"}
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5, err_msg=r)


def test_checkpoint_from_two_ranks_restores_at_one(world):
    """The FSDP ``Audio`` run's state, its shards gathered whole and written
    by rank 0 in JAX's ``multi_transform`` layout, restores at one process
    bit for bit: the trained parameters, their Adam moments, the running
    averages and the step."""
    got, restored = world["ranks"][0]["project Audio fsdp"], world["restored"]
    assert restored["step"] == 1
    for key, value in got["params"].items():
        np.testing.assert_array_equal(restored["params"][key], value, err_msg=key)
        np.testing.assert_array_equal(restored["mu"][key], got["mu"][key], err_msg=key)
    for key, value in got["stats"].items():
        np.testing.assert_array_equal(restored["stats"][key], value, err_msg=key)
