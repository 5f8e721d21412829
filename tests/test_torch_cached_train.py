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
import pytest
import torch

from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.data.preprocess import normalize_video
from acoustic_image_generation_tpu_torch.train import feature_cache as fc
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, as_raw, eval_generator

UNITS = (1, 1, 1, 1)
CLIPS = 2
WINDOW = 12 * 14 * 19 * 2048 * 4  # one window's f32 features


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    # 4 videos x 2 seconds = 8 one-second windows
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("cached_ds")), num_classes=2,
                                   videos_per_class=2, seconds_per_video=2, seed=1)


@pytest.fixture(scope="module")
def loader(lists):
    return AcousticImageDataLoader(lists["training"], "training", CLIPS, shuffle=False)


@pytest.fixture(scope="module")
def batch(loader):
    return next(iter(loader.batches(0)))


def trainer(seed=0, **config):
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen", seed=seed, **config)
    return Trainer(GenerationTask(cfg, device="cpu").init_params(seed))


def params(t: Trainer) -> dict:
    return {n: p.detach().clone() for n, p in t.task.named_parameters()}


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


def test_device_and_mixed_tiers_equal_the_host_tier(batch):
    """Two steps each: the host-tier trainer, one whose pool holds the whole
    batch (step 2 from the device tier), and one whose pool holds one of its
    two windows (step 2 mixed: the pool's window and a host row)."""
    runs = {}
    for name, pool in (("host", 0), ("device", 4 * WINDOW), ("mixed", WINDOW)):
        t = trainer(cache_trunk_features=True, cache_device_bytes=pool)
        state, _ = t.train_step(t.init_state(), batch)
        state, metrics = t.train_step(state, batch)
        assert (t.last_tier, t.trunk_runs) == (name, 1)
        runs[name] = (float(metrics["loss"]), params(t), t)
    assert runs["mixed"][2].device_cache.resident == 1 and len(runs["mixed"][2].feature_cache) == 1
    assert runs["device"][2].device_cache.resident == CLIPS and len(runs["device"][2].feature_cache) == 0
    for name in ("device", "mixed"):
        assert runs[name][0] == runs["host"][0]
        for n, p in runs[name][1].items():
            assert torch.equal(p, runs["host"][1][n]), (name, n)


def test_f8_storage_dtypes_and_loss_envelope(batch, tmp_path):
    exact = trainer(cache_trunk_features=True, cache_device_bytes=0)
    pooled = trainer(cache_trunk_features=True, cache_features_dtype="f8_e4m3")
    host = trainer(cache_trunk_features=True, cache_features_dtype="f8_e4m3", cache_device_bytes=0,
                   cache_disk_dir=str(tmp_path))
    loader = AcousticImageDataLoader.__new__(AcousticImageDataLoader)
    loader.plan = type("Plan", (), {"windows": [["a"], ["b"]]})
    host.attach_disk(loader)
    losses = {}
    for name, t in (("exact", exact), ("pooled", pooled), ("host", host)):
        state, metrics = t.train_step(t.init_state(), batch)
        losses[name] = float(metrics["loss"])
    assert pooled.device_cache.buf.dtype == torch.float8_e4m3fn
    row = host.feature_cache.get(int(batch.window_ids[0]))
    assert row.dtype == torch.float8_e4m3fn and row.shape == (12, 14, 19, 2048)
    assert host.feature_cache.disk.meta["dtype"] == "float8_e4m3fn"
    assert exact.feature_cache.get(int(batch.window_ids[0])).dtype == torch.float32  # "bf16": as produced
    for name in ("pooled", "host"):
        np.testing.assert_allclose(losses[name], losses["exact"], rtol=0.05)
    pooled.train_step(pooled.init_state(), batch)
    assert (pooled.last_tier, pooled.trunk_runs) == ("device", 1)
    with pytest.raises(ValueError, match="cache_features_dtype"):
        trainer(cache_trunk_features=True, cache_features_dtype="int4")


def test_disk_tier_serves_a_fresh_trainer(loader, batch, tmp_path):
    """A second trainer with the same frozen trunk over the same windows runs
    no trunk: its batch comes from the disk store, with the same loss. A
    trunk from another seed gets another store."""
    results = []
    for seed in (0, 0, 1):
        t = trainer(seed, cache_trunk_features=True, cache_device_bytes=4 * WINDOW,
                    cache_disk_dir=str(tmp_path))
        t.attach_disk(loader)
        t.attach_disk(loader)  # idempotent
        _, metrics = t.train_step(t.init_state(), batch)
        results.append((t.trunk_runs, t.last_tier, t.feature_cache.disk.dir, float(metrics["loss"])))
    (runs0, tier0, dir0, loss0), (runs1, tier1, dir1, loss1), (runs2, _, dir2, _) = results
    assert (runs0, tier0) == (1, "fill") and (runs1, tier1) == (0, "host") and runs2 == 1
    assert dir0 == dir1 != dir2 and loss1 == loss0
    assert len(fc.DiskFeatureStore(str(tmp_path), "x" * 24)) == 0


def test_int8_filled_features_equal_the_int8_trunk(batch):
    t = trainer(cache_trunk_features=True, cache_device_bytes=WINDOW, trunk_quant="int8", fused_qgemm=True)
    state, _ = t.train_step(t.init_state(), batch)
    assert t.qtrunk is not None and (t.trunk_runs, t.last_tier) == (1, "fill")
    video = torch.from_numpy(batch.video).reshape(-1, 224, 298, 3)
    with torch.no_grad():
        want = t.task.trunk_features(normalize_video(video), t.qtrunk)
    got = torch.cat([t.device_cache.gather([0]), t.feature_cache.get(int(batch.window_ids[1]))])
    assert torch.equal(got, want)
    t.train_step(state, batch)
    assert (t.trunk_runs, t.last_tier) == (1, "mixed")


@pytest.mark.parametrize("pool", [0, WINDOW], ids=["host", "pool"])
def test_partial_tier_runs_the_trunk_on_the_missing_rows(loader, pool):
    """A batch with one window cached and one in no tier (as a rank's are
    after a reshuffle moved windows from another rank): the trunk runs on
    the missing row alone, which is stored, and the step is the full
    step."""
    first, second = (as_raw(b) for b in list(loader.batches(0))[:2])
    mixed = {k: np.concatenate([first[k][1:], second[k][:1]]) for k in first if k != "valid"}
    full, t = trainer(), trainer(cache_trunk_features=True, cache_device_bytes=pool)
    s_full, s_cached = full.init_state(), t.init_state()
    for raw, tier, runs in ((first, "fill", 1), (mixed, "partial", 2), (mixed, "mixed" if pool else "host", 2)):
        s_full, m_full = full.train_step(s_full, raw)
        s_cached, m_cached = t.train_step(s_cached, raw)
        assert (t.last_tier, t.trunk_runs) == (tier, runs)
        np.testing.assert_allclose(float(m_cached["loss"]), float(m_full["loss"]), rtol=1e-5)
    assert len(t.feature_cache) == 3 - (pool > 0)


def test_cache_needs_a_frozen_trunk_and_window_ids(batch):
    assert trainer(cache_trunk_features=True).feature_cache is not None
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", cache_trunk_features=True)
    assert Trainer(GenerationTask(cfg, device="cpu")).feature_cache is None  # trunk_bn="train"
    t = trainer(cache_trunk_features=True)
    raw = {k: v for k, v in as_raw(batch).items() if k != "window_ids"}
    t.train_step(t.init_state(), raw)  # no ids: the full step
    assert (t.trunk_runs, t.last_tier, t.device_cache.resident) == (1, None, 0)


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
