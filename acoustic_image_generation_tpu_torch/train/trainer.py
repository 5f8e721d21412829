"""The generation train step.

Counterpart of ``acoustic_image_generation_tpu/train/trainer.py::Trainer``
(``__init__``, ``init_state``, ``_prepare`` and ``_step_core``): raw clips
-> device preprocessing -> train-mode forward and loss -> backward -> TF1
Adam on the trainable parameters. JAX runs it as one jitted program; here it
runs eagerly on the task's device and updates the state in place.

RNG: the VAE noise of step ``s`` comes from one ``torch.Generator`` seeded
from ``(seed, s)`` (``step_generator``), the counterpart of
``core/rng.py::train_step_rngs``. The two frameworks draw different numbers
from the same seed, so tests inject the noise instead (``eps``).
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.data.preprocess import Batch, preprocess_batch
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask, no_tf32
from acoustic_image_generation_tpu_torch.train.optim import TF1Adam
from acoustic_image_generation_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from ``(seed, step)``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


class Trainer:
    def __init__(self, task: GenerationTask):
        self.task = task
        self.cfg = task.cfg
        self.device = task.device

    def init_state(self) -> TrainState:
        """Step 0 and TF1 Adam over the task's trainable parameters (those
        that require grad; the frozen ones get no slots). The parameters are
        the task's as they stand: ``init_params`` or ``bridge.load_flax``."""
        trainable = [p for p in self.task.parameters() if p.requires_grad]
        return TrainState(step=0, task=self.task, optimizer=TF1Adam(trainable, self.cfg.learning_rate))

    def _prepare(self, raw: dict) -> Batch:
        """(B, F, ...) clips -> (B*F, ...) frames on the task's device ->
        device preprocessing with the acoustic image. ``raw``: ``acoustic``
        (B,F,36,48,12) float32, ``audio`` (B,F,1024) int32, ``video``
        (B,F,224,298,3) uint8 BGR, as numpy arrays or tensors."""
        flat = {}
        for key in ("acoustic", "audio", "video"):
            a = raw[key]
            t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
            flat[key] = t.reshape(-1, *t.shape[2:]).to(self.device, non_blocking=True)
        return preprocess_batch(flat["audio"], flat["video"], flat["acoustic"])

    def train_step(self, state: TrainState, raw: dict, *, eps=None) -> tuple[TrainState, dict]:
        """One step: prepare, loss and grads, TF1 Adam, trunk BN statistics
        updated. ``eps`` (frames, 150) replaces the step's VAE noise. Returns
        the state (updated in place, step advanced) and the loss terms as
        detached f32 scalars."""
        generator = None
        if eps is None:
            generator = step_generator(self.cfg.seed, state.step, self.device)
        else:
            eps = torch.as_tensor(np.array(eps, np.float32), device=self.device)
        with no_tf32():
            batch = self._prepare(raw)
            total, metrics = self.task.loss(batch, eps=eps, generator=generator)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}
