"""``Trainer.evaluate`` with and without the feature cache on the CPU:
evaluations of the same features within 1e-6 relative, and each batch's
own eval noise (``tests/test_torch_cached_train.py`` holds the cached train
step)."""

import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.train.trainer import as_raw, eval_generator
from cached_train_common import lists, trainer  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401


def test_evaluate_cached_equals_uncached(lists):
    """ae=True, so no noise: the cached evaluation, its second pass (no trunk
    run, the loader's own cache) and the uncached one agree, over batches of
    3 with a padded remainder batch."""
    valid = AcousticImageDataLoader(lists["validation"], "validation", 3)
    assert [b.valid for b in valid.batches(0)] == [3, 3, 2]
    t = trainer(cache_trunk_features=True, ae=True)
    state = t.init_state()
    first = t.evaluate(state, valid)
    assert t.trunk_runs == 3
    cache = t._eval_caches[valid]
    assert cache is not t.feature_cache and len(cache) == valid.num_windows
    assert t.device_cache.resident == 0  # the pool is kept for training windows
    again = t.evaluate(state, valid)
    uncached = t.evaluate(state, valid, use_cache=False)
    assert t.trunk_runs == 6 and cache.misses == 3
    assert set(first) == {"mse", "mse0", "mse1", "mse2", "mse3"}
    for k, v in first.items():
        assert np.isfinite(v)
        np.testing.assert_allclose(again[k], v, rtol=1e-6)
        np.testing.assert_allclose(uncached[k], v, rtol=1e-6)


def test_evaluate_draws_new_noise_for_every_batch(lists):
    """The VAE's eval noise of batch i comes from ``eval_generator(seed, i)``:
    one evaluation is the size-weighted mean of per-batch sums under those
    generators, and the batches' draws differ."""
    draws = [torch.randn(4, generator=eval_generator(0, i, "cpu")) for i in range(3)]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[1], draws[2])
    assert torch.equal(draws[0], torch.randn(4, generator=eval_generator(0, 0, "cpu")))
    valid = AcousticImageDataLoader(lists["validation"], "validation", 4)
    t = trainer()
    state = t.init_state()
    got = t.evaluate(state, valid)
    sums, count = {}, 0.0
    for i, b in enumerate(valid.batches(0)):
        s, n = t._eval_sums(as_raw(b), None, eval_generator(0, i, "cpu"))
        sums = {k: sums.get(k, 0.0) + float(v) for k, v in s.items()}
        count += float(n)
    for k, v in got.items():
        np.testing.assert_allclose(v, sums[k] / count, rtol=1e-6)
    # the step's generator, shared by every batch, would give another value
    same = [t.eval_step(state, b) for b in valid.batches(0)]
    assert sum(float(s["mse"]) for s, _ in same) / count != pytest.approx(got["mse"], rel=1e-9)
