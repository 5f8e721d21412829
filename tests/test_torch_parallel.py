"""The generation task on two ranks (``parallel/mesh.py``: one process a
device, gloo on the CPU) against JAX's ``Trainer`` on a two-device CPU mesh
(one program over the global batch) and against the port's own one-process
step, in f32 at ResNet 1/1/1/1, 2 clips of 2 frames (one clip a rank).

One spawn of two ranks (``tests/parallel_ranks.py``) runs every port case
while the JAX references compile in this process; the same weights (the
port's ``init_params(0)`` through the bridge) and the same noise (a numpy
draw, handed to the port as ``eps`` and to JAX in place of its
``jax.random.normal``) go into both.

Tolerances, and why:

- the 2-rank DDP step against JAX's mesh and against the port's one
  process, over 2 steps: ``tests/test_torch_train.py``'s trajectory
  criteria (losses 1e-5 relative; each trained tensor's update within 2 lr
  entry by entry, 99% within lr/4, 10% in L2; frozen tensors bit-frozen;
  BN running averages within 1e-3 of how far they moved). Sums over two
  ranks' rows are the same f32 arithmetic in another order.
- the FSDP step against the DDP step: the same criteria (FSDP's
  reduce-scatter and DDP's all-reduce sum the same gradients).
- the two ranks against each other: bit for bit (every rank applies the
  same averaged gradients and the same global statistics).
- the noise rows, the int8 amaxes and the checkpoint written at two ranks
  and restored at one: bit for bit (a slice of the same draw; ``MAX`` is
  exact; a file).
- the global ``fused_bn_stats`` moments and running averages: 1e-6
  relative (two partial sums against one sum).
- ``evaluate`` with a remainder batch, and the cached steps' losses: 1e-5
  relative.
- Adam's moments against the one process's: 1e-2 of each leaf's largest
  entry (the gradients' f32 sums in another order: read 1.3e-3 on
  ``generator/dense/kernel``, whose gradients sit at 1e-9; a sum over the
  ranks where their mean belongs would be 2x and 4x).
"""

import concurrent.futures as cf
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_ranks as pr
from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.parallel import fsdp_sharding, make_mesh
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.data.preprocess import normalize_video
from acoustic_image_generation_tpu_torch.ops.conv_stats import conv1x1_batch_stats
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, step_generator
from torch_tmp import module_dir

LR = pr.LR
CLIPS, FRAMES = 2, 2
MOMENT_TOL = 1e-2  # Adam's mu and nu against one process's, of the leaf's largest entry


def raw_clips(seed):
    rng = np.random.default_rng(seed)
    f = (CLIPS, FRAMES)
    return dict(acoustic=rng.random((*f, 36, 48, 12), dtype=np.float32),
                audio=rng.integers(-(2**15), 2**15, (*f, 1024)).astype(np.int32),
                video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def check_trajectory(got, want, init, trained):
    """``tests/test_torch_train.py``'s criteria: ``got`` and ``want``
    (``(params, stats)`` flax trees) from ``init``."""
    (gp, gs), (wp, ws), (ip, is_) = got, want, init
    wp, ip = dict(leaves(wp)), dict(leaves(ip))
    for key, value in leaves(gp):
        if key not in trained:
            np.testing.assert_array_equal(value, ip[key], err_msg=key)
            continue
        d_got, d_want = value - ip[key], wp[key] - ip[key]
        gap = np.abs(d_got - d_want)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_want), key
    ws, is_ = dict(leaves(ws)), dict(leaves(is_))
    for key, value in leaves(gs):
        moved = np.abs(ws[key] - is_[key]).max()
        assert np.abs(value - ws[key]).max() <= 1e-3 * moved, key


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


def jax_cfg(tmp, batch, **model):
    return ExperimentConfig(data=DataConfig(batch_size=batch), model=ModelConfig(resnet_units=pr.UNITS, **model),
                            optim=OptimConfig(learning_rate=LR), run=RunConfig(checkpoint_dir=str(tmp), exp_name="jax"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=2))


def jax_state(jtr, batch, init):
    state = jtr.init_state(batch)
    return state.replace(params=jax.device_put(init[0], jtr._replicated),
                         batch_stats=jax.device_put(init[1], jtr._replicated))


def as_jax_batch(raw):
    n = raw["audio"].shape[0]
    return JaxRawBatch(raw["acoustic"], raw["audio"], raw["video"], np.zeros(n, np.int32), np.zeros(n, np.int32), n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the spawn of two ranks (in a thread) and the JAX
    references."""
    with module_dir(tmp_path_factory, "parallel", need_mb=1000) as tmp:  # the checkpoints: hundreds of MB
        lists = write_synthetic_dataset(str(tmp / "ds"), num_classes=1, videos_per_class=1, seconds_per_video=3, seed=4)
        spec = dict(init=bridge.to_flax(pr.task()), ae_init=bridge.to_flax(pr.task(ae=True)),
                    raws=[raw_clips(100), raw_clips(101)],
                    eps=np.random.default_rng(7).standard_normal((CLIPS * FRAMES, 150)).astype(np.float32),
                    stats_input=np.random.default_rng(8).standard_normal((4, 6, 5, 64)).astype(np.float32),
                    valid_list=lists["validation"], ddp_dir=str(tmp / "ddp"), fsdp_dir=str(tmp / "fsdp"))
        pool = cf.ThreadPoolExecutor(1)
        ranks = pool.submit(mesh.launch, pr.run_cases, 2, spec, device="cpu", tmp_dir=str(tmp))

        # JAX's Trainer over a two-device mesh: two steps from the same weights and noise
        jtr = JaxTrainer(JaxTask(jax_cfg(tmp, CLIPS)), jax_cfg(tmp, CLIPS))
        state = jax_state(jtr, as_jax_batch(spec["raws"][0]), spec["init"])
        template = jax.device_get(state)  # the train step donates its state
        losses = []
        with jax_noise(spec["eps"]):
            for raw in spec["raws"]:
                state, metrics = jtr.train_step(state, as_jax_batch(raw))
                losses.append(float(metrics["loss"]))
        jax_final = jax.device_get((state.params, state.batch_stats))
        specs = dict(_specs(fsdp_sharding(spec["init"][0], make_mesh(2))))
        # JAX's evaluate over a remainder batch (ae: no noise)
        jae = JaxTrainer(JaxTask(jax_cfg(tmp, 2, ae=True)), jax_cfg(tmp, 2, ae=True))
        jloader = JaxLoader(lists["validation"], "validation", 2)
        jeval = jae.evaluate(jax_state(jae, next(iter(jloader.batches(0))), spec["ae_init"]), jloader)

        out = ranks.result()
        pool.shutdown()
        yield dict(spec=spec, ranks=out, jax_losses=losses, jax_final=jax_final, jax_specs=specs, jax_eval=jeval,
                   jax_template=template, lists=lists)


def _specs(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _specs(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tuple(v.spec)


@pytest.fixture(scope="module")
def single(world):
    """The port's one-process step from the same weights and noise."""
    spec = world["spec"]
    trainer = Trainer(pr.task(spec["init"]), pconfig.ExperimentConfig(optim=pconfig.OptimConfig(learning_rate=LR)))
    state = trainer.init_state()
    losses = []
    for raw in spec["raws"]:
        state, metrics = trainer.train_step(state, raw, eps=spec["eps"])
        losses.append(float(metrics["loss"]))
    return dict(losses=losses, final=bridge.to_flax(trainer.task), task=trainer.task, state=ckpt.state_dict(state))


def trained_keys(task):
    return {"/".join(p) for t, c, p, _ in bridge.targets(task) if c == "params" and t.requires_grad}


def test_ddp_step_matches_jax_mesh(world, single):
    r0 = world["ranks"][0]["ddp"]
    np.testing.assert_allclose([m["loss"] for m in r0["losses"]], world["jax_losses"], rtol=1e-5)
    check_trajectory((r0["params"], r0["stats"]), world["jax_final"], world["spec"]["init"],
                     trained_keys(single["task"]))


def test_ddp_step_matches_one_process(world, single):
    r0 = world["ranks"][0]["ddp"]
    np.testing.assert_allclose([m["loss"] for m in r0["losses"]], single["losses"], rtol=1e-5)
    check_trajectory((r0["params"], r0["stats"]), single["final"], world["spec"]["init"],
                     trained_keys(single["task"]))


@pytest.mark.parametrize("case", ["ddp", "fsdp"])
def test_ranks_hold_the_same_state_and_metrics(world, case):
    a, b = (world["ranks"][r][case] for r in (0, 1))
    assert a["losses"] == b["losses"]
    for tree in ("params", "stats"):
        got, want = dict(leaves(a[tree])), dict(leaves(b[tree]))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the trunk's train-mode BN moved its running averages (over the global batch)
    init = dict(leaves(world["spec"]["init"][1]))
    key = "resnet/block1_unit_1/conv1/BatchNorm/mean"
    assert not np.array_equal(dict(leaves(a["stats"]))[key], init[key])


def test_noise_rows_are_the_global_draw(world, single):
    rows = CLIPS * FRAMES // 2
    full = torch.randn((CLIPS * FRAMES, 150), generator=step_generator(0, 0, "cpu")).numpy()
    for r in (0, 1):
        np.testing.assert_array_equal(world["ranks"][r]["noise"]["rows"], full[r * rows:(r + 1) * rows])
    # a step without eps: the one-process step's noise, so its loss
    trainer = Trainer(pr.task(world["spec"]["init"]), pconfig.ExperimentConfig(optim=pconfig.OptimConfig(learning_rate=LR)))
    _, metrics = trainer.train_step(trainer.init_state(), world["spec"]["raws"][0])
    for r in (0, 1):
        np.testing.assert_allclose(world["ranks"][r]["noise"]["loss"], float(metrics["loss"]), rtol=1e-5)


def test_fused_bn_stats_sums_cover_the_global_batch(world):
    spec = world["spec"]
    task = pr.fuse_bn_stats(pr.task(spec["init"]))
    conv = task.resnet.block1_unit_1.conv1
    with torch.no_grad():
        task.resnet(normalize_video(torch.from_numpy(spec["raws"][0]["video"]).flatten(0, 1)), mode="trunk",
                    train=True)
        _, mean, var = conv1x1_batch_stats(torch.from_numpy(spec["stats_input"]),
                                           conv.weight.reshape(conv.weight.shape[0], -1).t())
    want = {n: b.numpy() for n, b in task.resnet.named_buffers()}
    for r in (0, 1):
        got = world["ranks"][r]["fused"]
        np.testing.assert_allclose(got["mean"], mean.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["var"], var.numpy(), rtol=1e-6, atol=1e-7)
        for n in want:
            np.testing.assert_allclose(got["running"][n], want[n], rtol=1e-6, atol=1e-7, err_msg=n)
    assert any(m.fused_stats for m in task.resnet.modules() if hasattr(m, "fused_stats"))


def test_int8_amaxes_are_the_global_calibration(world):
    spec = world["spec"]
    task = pr.task(spec["init"], trunk_bn="frozen", trunk_quant="int8")
    want = task.build_qtrunk(normalize_video(torch.from_numpy(spec["raws"][0]["video"]).flatten(0, 1))).act.numpy()
    for r in (0, 1):
        np.testing.assert_array_equal(world["ranks"][r]["amax"], want)


def test_fsdp_layout_matches_jax_fsdp_sharding(world, single):
    """Every trained tensor JAX shards is sharded on the port's dim of the
    same flax axis; the ones JAX keeps whole stay whole."""
    placements = world["ranks"][0]["fsdp"]["placements"]
    name_of = {id(t): n for n, t in single["task"].named_parameters()}
    sharded = 0
    for tensor, coll, path, fn in bridge.targets(single["task"]):
        if coll != "params" or not tensor.requires_grad:
            continue
        jspec = world["jax_specs"]["/".join(path)]
        axis = next((i for i, a in enumerate(jspec) if a is not None), None)
        _, axes = bridge.flax_layout(fn, tuple(tensor.shape))
        assert placements[name_of[id(tensor)]] == (None if axis is None else axes[axis]), "/".join(path)
        sharded += axis is not None
    assert sharded >= 5  # conv_map, the VAE head's two convs, the dense, layer6's first chain conv
    assert world["ranks"][0]["fsdp"]["moments_bytes"] < 0.7 * world["ranks"][0]["ddp"]["moments_bytes"]


def test_fsdp_step_matches_ddp(world, single):
    ddp, fsdp = world["ranks"][0]["ddp"], world["ranks"][0]["fsdp"]
    np.testing.assert_allclose([m["loss"] for m in fsdp["losses"]], [m["loss"] for m in ddp["losses"]], rtol=1e-5)
    check_trajectory((fsdp["params"], fsdp["stats"]), (ddp["params"], ddp["stats"]), world["spec"]["init"],
                     trained_keys(single["task"]))


def test_cached_step_keeps_each_ranks_windows(world):
    spec = world["spec"]
    trainer = Trainer(pr.task(spec["init"], trunk_bn="frozen", cache_trunk_features=True),
                      pconfig.ExperimentConfig(optim=pconfig.OptimConfig(learning_rate=LR)))
    state = trainer.init_state()
    losses = []
    for raw in spec["raws"]:
        state, metrics = trainer.train_step(state, dict(raw, window_ids=np.arange(CLIPS)), eps=spec["eps"])
        losses.append(float(metrics["loss"]))
    for r in (0, 1):
        got = world["ranks"][r]["cached"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert got["tiers"] == ["fill", "device"] and got["trunk_runs"] == 1
        assert got["windows"] == [r]  # global window ids, this rank's rows only


def test_evaluate_with_a_remainder_batch_matches_jax(world):
    assert [world["ranks"][r]["eval"]["valid"] for r in (0, 1)] == [[1, 1], [1, 0]]
    want = world["jax_eval"]
    for r in (0, 1):
        res = world["ranks"][r]["eval"]["sums"]
        assert res.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(res[k], want[k], rtol=1e-5, err_msg=(r, k))


@pytest.mark.parametrize("case", ["ddp", "fsdp"])
def test_checkpoint_from_two_ranks_restores_at_one_and_in_jax(world, single, case):
    path = f"{world['spec'][case + '_dir']}/par/epoch_final.ckpt"
    assert int(ckpt.read_state_dict(path)["step"]) == len(world["spec"]["raws"])
    trainer = Trainer(pr.task(), pconfig.ExperimentConfig(optim=pconfig.OptimConfig(learning_rate=LR)))
    state = trainer.restore(path, trainer.init_state())
    assert state.step == 2
    params, stats = bridge.to_flax(trainer.task)
    want = world["ranks"][0][case]
    for tree, ref in ((params, want["params"]), (stats, want["stats"])):
        ref = dict(leaves(ref))
        for k, v in leaves(tree):
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    # and the file is JAX's: its restore reads the same parameters
    restored = jax.device_get(jckpt.restore_checkpoint(path, world["jax_template"]))
    jparams = dict(leaves(restored.params))
    for k, v in leaves(params):
        np.testing.assert_array_equal(jparams[k], v, err_msg=k)
    assert int(restored.step) == 2


@pytest.mark.parametrize("case", ["ddp", "fsdp"])
def test_adam_moments_are_the_global_gradients(world, single, case):
    """Adam's steps do not see a gradient's scale, its moments do: a sum
    over the ranks where the mean belongs would show here as 2x in ``mu``
    and 4x in ``nu``."""
    got = ckpt.read_state_dict(f"{world['spec'][case + '_dir']}/par/epoch_final.ckpt")["opt_state"]
    want = single["state"]["opt_state"]
    for slot in ("mu", "nu"):
        w = dict(leaves(want["inner_states"]["train"]["inner_state"]["0"][slot]))
        g = dict(leaves(got["inner_states"]["train"]["inner_state"]["0"][slot]))
        assert g.keys() == w.keys()
        for k in w:
            if w[k].dtype != object:  # a frozen subtree's {}
                scale = np.abs(w[k]).max()
                assert np.abs(g[k] - w[k]).max() <= MOMENT_TOL * scale, (slot, k, float(np.abs(g[k] - w[k]).max() / scale))


FAMILIES = {
    "classification": ["--model", "DualCamNet", "--mfcc", "1"],
    "correspondence": ["--model", "DualCamNet", "--correspondence", "1"],
    "projection": ["--embedding", "1", "--project", "1"],
    "joint": ["--embedding", "1", "--jointmvae", "1"],
    "generation_correspondence": ["--embedding", "1", "--mfcc", "1", "--correspondence", "1"],
}
TAKEN = {  # trained on ranks by tests/test_torch_parallel_embed.py and test_torch_parallel_reconstruct.py
    "embedding": ["--embedding", "1"],
    "reconstruction": ["--model", "UNet", "--encoder_type", "Ac"],
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_what_waits_raises_at_two_devices(family):
    """Every family takes two devices (tests/test_torch_parallel_project.py, test_torch_parallel_classify.py),
    and tensor parallelism beside them (tests/test_torch_tensor_parallel_families.py and
    test_torch_tensor_parallel_correspondence.py): nothing waits any more. JAX's ValueError of fsdp beside it
    still stands."""
    cfg = pmain.config_from_args(pmain.build_parser().parse_args(FAMILIES[family] + ["--num_devices", "2"]))
    assert pmain.task_config(cfg)[1] == pmain.task_config(pmain.config_from_args(
        pmain.build_parser().parse_args(FAMILIES[family])))[1]
    tp = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, tensor_parallel=2))
    assert pmain.task_config(tp) == pmain.task_config(cfg)
    with pytest.raises(ValueError, match="fsdp and tensor_parallel are mutually exclusive"):
        pmain.task_config(dataclasses.replace(tp, parallel=dataclasses.replace(tp.parallel, fsdp=True)))


@pytest.mark.parametrize("family", sorted(TAKEN))
def test_embedding_and_reconstruction_take_two_devices(family):
    """... and, with tensor_parallel=2, as a (1, 2) grid (tests/test_torch_tensor_parallel_tasks.py)."""
    for flags in (["--num_devices", "2"], []):
        cfg = pmain.config_from_args(pmain.build_parser().parse_args(TAKEN[family] + flags))
        pmain.task_config(cfg)
        tp = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, tensor_parallel=2))
        assert pmain.task_config(tp) == pmain.task_config(cfg)


def test_trainer_refuses_other_tasks_on_two_ranks(world):
    """The trainer refuses no task on two ranks: it takes the classification task and the generation task with
    correspondence under DDP (each trained on ranks in tests/test_torch_parallel_classify.py) and with
    tensor_parallel=2 as a (1, 2) grid (trained so in tests/test_torch_tensor_parallel_families.py and
    test_torch_tensor_parallel_correspondence.py): DualCamNet splits nothing, the correspondence task's trunk
    its 12 wide convs. What still raises is JAX's ValueError of fsdp beside it, and one process cannot form the
    grid."""
    assert world["ranks"][0]["refusals"] == {"classification": None, "correspondence": None}
    assert [r["tensor_parallel"] for r in world["ranks"]] == [{"classification": 0, "correspondence": 12}] * 2
    tp = pconfig.ExperimentConfig(parallel=pconfig.ParallelConfig(tensor_parallel=2))
    for make in (pconfig.generation_config, pconfig.project_config, pconfig.joint_config, pconfig.classify_config):
        assert make(tp) == make(pconfig.ExperimentConfig())
    with pytest.raises(ValueError, match="fsdp and tensor_parallel are mutually exclusive"):
        pconfig.generation_config(pconfig.ExperimentConfig(parallel=pconfig.ParallelConfig(tensor_parallel=2,
                                                                                           fsdp=True)))
    for task in (pr.task(correspondence=True), ClassificationTask(ClassifyConfig(compute_dtype="float32"),
                                                                  device="cpu")):
        with pytest.raises(ValueError, match="1 ranks do not split into model groups of tensor_parallel=2"):
            Trainer(task, tp)


def test_shard_batch_cuts_rows_as_the_host_sharded_loader(world):
    """A rank's loader decodes the global batch's rows ``mesh.shard_rows``
    gives it, with its share of a remainder batch's valid prefix."""
    lists = world["lists"]
    whole = list(AcousticImageDataLoader(lists["validation"], "validation", 2).batches(0))
    for r in (0, 1):
        own = list(AcousticImageDataLoader(lists["validation"], "validation", 2, shard_index=r,
                                           shard_count=2).batches(0))
        lo, hi = mesh.row_range(2, r, 2)
        for a, b in zip(own, whole, strict=True):
            assert a.valid == max(0, min(b.valid - lo, hi - lo))
            np.testing.assert_array_equal(a.window_ids, mesh.shard_rows(b.window_ids, r, 2))
            np.testing.assert_array_equal(a.video, mesh.shard_rows(b.video, r, 2))
    with pytest.raises(ValueError, match="do not split"):
        mesh.row_range(3, 0, 2)


def test_fsdp_axis_is_jaxs_rule():
    shapes = {"big_out": (3, 3, 256, 128), "odd_out": (12, 16, 145, 150), "small": (3, 3, 64, 64),
              "dense": (150, 2304), "vector": (1 << 20,), "narrow": (4096, 12), "tall": (16, 32768)}
    tree = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    for n in (2, 4, 8):
        specs = dict(_specs(fsdp_sharding(tree, make_mesh(n))))
        for k, shape in shapes.items():
            axis = next((i for i, a in enumerate(specs[k]) if a is not None), None)
            assert mesh.fsdp_axis(shape, n) == axis, (k, n)
