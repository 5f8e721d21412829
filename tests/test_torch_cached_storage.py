"""The feature cache's storage on the CPU: float8 rows (the loss within 5%
of exact storage's, JAX's envelope) and the disk tier that serves a fresh
trainer (the same loss to the bit). ``tests/test_torch_cached_train.py``
gives the other tolerances."""

import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.train import feature_cache as fc
from cached_train_common import WINDOW, batch, lists, loader, trainer  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401


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
