"""The port's epoch loop against itself, in f32 on the CPU, at ResNet
1/1/1/1 on the synthetic shards (``tests/fit_common.py``): an ordinary
resume and a mid-epoch resume from the crash checkpoint each end bit for
bit in the uninterrupted run's state, and a fault inside the optimizer's
update writes no crash checkpoint. ``tests/test_torch_fit.py`` holds the
loop against JAX's ``fit``."""

import pytest

from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.optim import TF1Adam
from fit_common import STEPS_PER_EPOCH, _assert_same_state, _loaders, _port, _records, lists, uninterrupted  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401


def test_ordinary_resume_is_the_uninterrupted_run(lists, uninterrupted, tmp_path):
    """The uninterrupted run's epoch-0 snapshot, restored into a fresh
    trainer and trained one more epoch, is that run's final state."""
    resumed = _port(tmp_path, "resumed", epochs=1, weights_seed=9)  # its own weights are overwritten
    state = resumed.restore(f"{uninterrupted[0].run_dir}/epoch_0.ckpt", resumed.init_state())
    assert state.step == STEPS_PER_EPOCH
    state = resumed.fit(*_loaders(lists), state=state)
    assert [r["epoch"] for r in _records(resumed)] == [1]  # numbering goes on from the step
    _assert_same_state(state, uninterrupted[1])
    assert _records(resumed)[0]["valid"] == _records(uninterrupted[0])[1]["valid"]


class FaultyLoader:
    """A loader whose ``epoch`` raises after ``after`` batches."""

    def __init__(self, loader, epoch: int, after: int):
        self.loader, self.epoch, self.after = loader, epoch, after

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def batches(self, epoch: int = 0):
        for i, batch in enumerate(self.loader.batches(epoch)):
            if epoch == self.epoch and i == self.after:
                raise OSError("shard read failed")
            yield batch


def test_crash_checkpoint_and_mid_epoch_resume(lists, uninterrupted, tmp_path, capsys):
    train, valid = _loaders(lists)
    crashed = _port(tmp_path, "crashed")
    with pytest.raises(OSError, match="shard read failed"):
        crashed.fit(FaultyLoader(train, epoch=1, after=1), valid)
    path = f"{crashed.run_dir}/epoch_interrupted_1.ckpt"
    assert ckpt.load_resume_meta(path) == {"epoch": 1, "step_in_epoch": 1}
    assert "crash checkpoint" in capsys.readouterr().err
    assert [r["epoch"] for r in _records(crashed)] == [0]

    resumed = _port(tmp_path, "resumed", epochs=1, weights_seed=9)
    state = resumed.restore(path, resumed.init_state())
    assert state.step == STEPS_PER_EPOCH + 1
    state = resumed.fit(train, valid, state=state)
    assert [(r["epoch"], r["steps"]) for r in _records(resumed)] == [(1, 1)]  # one batch skipped
    _assert_same_state(state, uninterrupted[1])


def test_no_crash_checkpoint_from_a_torn_update(lists, tmp_path, monkeypatch, capsys):
    """A fault inside the optimizer's in-place update leaves some tensors
    updated and others not: no checkpoint is written from that state."""
    trainer = _port(tmp_path, "torn")
    real_step = TF1Adam.step

    def step_then_fail(self, closure=None):
        params = self.param_groups[0]["params"]
        self.param_groups[0]["params"] = params[:3]  # three tensors updated, then the fault
        try:
            real_step(self)
        finally:
            self.param_groups[0]["params"] = params
        raise RuntimeError("device fault")

    monkeypatch.setattr(TF1Adam, "step", step_then_fail)
    with pytest.raises(RuntimeError, match="device fault"):
        trainer.fit(*_loaders(lists))
    assert "no crash checkpoint written" in capsys.readouterr().err
    assert not list((tmp_path / "torn").glob("*.ckpt"))
