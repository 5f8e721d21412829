"""The port's cached-feature training path on the CPU, small: shards ->
loader -> ``Trainer.train_step`` with ``cache_trunk_features=True`` ->
``Trainer.evaluate``, at ``resnet_units=(1, 1, 1, 1)``, f32, batches of 2
one-second clips (24 frames). The JAX package's counterparts of these
checks (``tests/test_trainer.py``'s cache tests) are slow-marked there; here
they run in tier 1, and ``test_torch_cached_train_jax.py`` holds the port's
cached step and ``evaluate`` against JAX's.

Tolerances, and why: the cached step computes the same f32 operations on
the same features as the full step, so the loss is held to 1e-5 relative
and the parameters to 2e-4 relative + 2e-6 absolute (the JAX test's
limits; the port reads bit-equal). The tiers hand the step the same bits,
so device, mixed and host-tier steps are held to equality. f8 storage
rounds the features once: its loss within 5% of exact storage's (JAX's
envelope). Evaluations of the same features: 1e-6 relative.
"""

import numpy as np

from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, as_raw
from cached_train_common import CLIPS, UNITS, batch, lists, loader, params, trainer  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401


def test_cached_step_equals_the_full_step(batch):
    full, cached = trainer(), trainer(cache_trunk_features=True, cache_device_bytes=0)
    assert full.feature_cache is None and cached.feature_cache is not None
    s_full, s_cached = full.init_state(), cached.init_state()
    for step in range(2):
        s_full, m_full = full.train_step(s_full, batch)
        s_cached, m_cached = cached.train_step(s_cached, batch)
        np.testing.assert_allclose(float(m_cached["loss"]), float(m_full["loss"]), rtol=1e-5)
        want = params(full)
        for n, p in params(cached).items():
            np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=2e-4, atol=2e-6, err_msg=n)
    # step 2 came from the host tier: no trunk run, every window a hit
    assert (full.trunk_runs, cached.trunk_runs, cached.last_tier) == (2, 1, "host")
    assert (cached.feature_cache.hits, cached.feature_cache.misses) == (CLIPS, 1)
    assert len(cached.feature_cache) == CLIPS


def test_cache_needs_a_frozen_trunk_and_window_ids(batch):
    assert trainer(cache_trunk_features=True).feature_cache is not None
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", cache_trunk_features=True)
    assert Trainer(GenerationTask(cfg, device="cpu")).feature_cache is None  # trunk_bn="train"
    t = trainer(cache_trunk_features=True)
    raw = {k: v for k, v in as_raw(batch).items() if k != "window_ids"}
    t.train_step(t.init_state(), raw)  # no ids: the full step
    assert (t.trunk_runs, t.last_tier, t.device_cache.resident) == (1, None, 0)
