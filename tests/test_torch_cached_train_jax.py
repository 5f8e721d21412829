"""The port's cached-feature step and ``Trainer.evaluate`` against the JAX
package's, in f32 on the CPU, from the same weights (``bridge.load_flax``)
and the same shards. JAX's trainer runs on a one-device mesh, so that a
batch may hold one clip.

Tolerances, and why: the step is held as ``tests/test_torch_train.py``
holds its 3-step trajectory: the loss to 1e-5 relative; each trained
tensor's update (new - initial) entry by entry within 2 lr, 99% within
lr/4 and within 10% in L2 norm, since Adam turns a gradient at
rounding-noise level into a full +-lr step of either sign; the frozen
trunk bit-frozen. ``evaluate`` (``ae=True``, no noise): the mean losses to
1e-5 relative, the same f32 arithmetic summed in another order.
"""

import numpy as np
import pytest

from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

UNITS = (1, 1, 1, 1)
LR = 1e-4


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    # 2 videos x 2 seconds = 4 one-second windows
    with module_dir(tmp_path_factory, "jax_cached_ds") as tmp:
        yield write_synthetic_dataset(str(tmp), num_classes=2, videos_per_class=1, seconds_per_video=2, seed=2)


def jax_trainer(tmp_path, clips, **model):
    cfg = ExperimentConfig(
        data=DataConfig(batch_size=clips, sample_length=1),
        model=ModelConfig(resnet_units=UNITS, trunk_bn="frozen", cache_trunk_features=True, cache_device_bytes=0,
                          **model),
        optim=OptimConfig(learning_rate=LR),
        run=RunConfig(exp_name="cached", checkpoint_dir=str(tmp_path), seed=0),
        parallel=ParallelConfig(compute_dtype="float32"),
    )
    return JaxTrainer(JaxTask(cfg), cfg, mesh=make_mesh(1))


def port_trainer(init, **config):
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen",
                           cache_trunk_features=True, learning_rate=LR, **config)
    task = GenerationTask(cfg, device="cpu")
    bridge.load_flax(task, *init)
    return Trainer(task)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_cached_step_matches_jax(lists, tmp_path):
    """One clip through each package's cached step (a fill: the trunk runs,
    its features are stored, the head and generator train on them), with
    JAX's noise injected into the port."""
    import jax

    batch = next(iter(JaxLoader(lists["training"], "training", 1, shuffle=False).batches(0)))
    jtr = jax_trainer(tmp_path, 1)
    state = jtr.init_state(batch)
    init = jax.device_get((state.params, state.batch_stats))
    # the noise JAX's step draws: its latent key, through the same forward
    rngs = jrng.train_step_rngs(jtr.base_key, 0)
    raw = jtr._cached_raw(batch)
    feat = jtr._trunk_features(state, jax.device_put(batch.video), None)
    out, _ = jtr.task._forward(state.params, state.batch_stats, jtr._prepare(raw, key=rngs["data"]), rngs,
                               train=True, trunk_feat=feat)
    eps = np.asarray((out.z - out.mean) / out.std)
    state, jax_metrics = jtr.train_step(state, batch)
    assert len(jtr.feature_cache) == 1  # JAX's step went through its cache
    want_p = dict(leaves(jax.device_get(state.params)))

    port = port_trainer(init, cache_device_bytes=0)
    _, metrics = port.train_step(port.init_state(), batch, eps=eps)
    assert (port.trunk_runs, port.last_tier, len(port.feature_cache)) == (1, "fill", 1)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    labels = port.task.param_labels()
    name_of = {id(t): n for n, t in port.task.named_parameters()}
    paths = {"/".join(path): name_of.get(id(t)) for t, _, path, _ in bridge.targets(port.task)}
    init_p = dict(leaves(init[0]))
    got_p, _ = bridge.to_flax(port.task)
    for key, value in leaves(got_p):
        if labels[paths[key]] == "frozen":
            np.testing.assert_array_equal(value, init_p[key], err_msg=key)
            np.testing.assert_array_equal(want_p[key], init_p[key], err_msg=key)
            continue
        d_port, d_jax = value - init_p[key], want_p[key] - init_p[key]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
        assert np.abs(d_jax).max() > 0 and np.abs(d_port).max() > 0, key  # every trained leaf moved


def test_evaluate_matches_jax(lists, tmp_path):
    """``ae=True`` (no noise): JAX's cached ``evaluate`` and the port's over
    the same 4 validation windows in batches of 3 (a padded remainder batch
    of 1), from the same weights; the port's second pass runs no trunk."""
    import jax

    jloader = JaxLoader(lists["validation"], "validation", 3)
    jtr = jax_trainer(tmp_path, 3, ae=True)
    state = jtr.init_state(next(iter(jloader.batches(0))))
    init = jax.device_get((state.params, state.batch_stats))
    want = jtr.evaluate(state, jloader)

    loader = AcousticImageDataLoader(lists["validation"], "validation", 3)
    assert [b.valid for b in loader.batches(0)] == [3, 1]
    port = port_trainer(init, ae=True)
    pstate = port.init_state()
    got = port.evaluate(pstate, loader)
    again = port.evaluate(pstate, loader)
    assert port.trunk_runs == 2
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert again[k] == got[k]
