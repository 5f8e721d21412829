"""The device and mixed tiers of the cached-feature step against the host
tier, and the int8 trunk's fill, on the CPU (``tests/test_torch_cached_train.py``
holds the cached step against the full step; its docstring gives the
tolerances: the tiers hand the step the same bits, so they are held to
equality)."""

import torch

from acoustic_image_generation_tpu_torch.data.preprocess import normalize_video
from cached_train_common import CLIPS, WINDOW, batch, lists, loader, params, trainer  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401


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
