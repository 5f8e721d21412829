"""The partial tier of the cached-feature step on the CPU: a batch with one
window cached and one in no tier, held against the full step (loss within
1e-5 relative, as ``tests/test_torch_cached_train.py`` holds the cached
step)."""

import numpy as np
import pytest

from acoustic_image_generation_tpu_torch.train.trainer import as_raw
from cached_train_common import WINDOW, lists, loader, trainer  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401


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
