"""The train step, for the generation task or the embedding task.

Counterpart of ``acoustic_image_generation_tpu/train/trainer.py::Trainer``
(``__init__``, ``init_state``, ``_prepare``, ``_step_core``,
``_eval_step_impl`` and ``_maybe_build_qtrunk``): raw clips -> device
preprocessing -> train-mode forward and loss -> backward -> TF1 Adam on the
trainable parameters. JAX runs it as one jitted program; here it runs
eagerly on the task's device and updates the state in place, the BN
running averages of train-mode BNs included. A task whose ``reads_mfcc``
is false (``EmbedTask``) gets batches without the MFCC frontend (JAX's jit
drops it as dead code); ``eval_step`` is the generation task's only.

With ``trunk_quant="int8"`` the trainer folds, quantizes and calibrates the
trunk once, from the normalized frames of the first batch it sees (train
or eval), and every later step runs the int8 trunk (``Trainer.qtrunk``).

RNG: the noise of step ``s`` (the VAE noise; the embedding task's shared
``eps`` and moddrop draws) comes from one ``torch.Generator`` seeded from
``(seed, s)`` (``step_generator``), the counterpart of
``core/rng.py::train_step_rngs``. The two frameworks draw different numbers
from the same seed, so tests inject the noise instead (``eps``,
``moddrop``).
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.data.preprocess import Batch, normalize_video, preprocess_batch
from acoustic_image_generation_tpu_torch.train.embed import EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask, no_tf32
from acoustic_image_generation_tpu_torch.train.optim import TF1Adam
from acoustic_image_generation_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from ``(seed, step)``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


class Trainer:
    def __init__(self, task: GenerationTask | EmbedTask):
        self.task = task
        self.cfg = task.cfg
        self.device = task.device
        self.qtrunk = None  # the int8 trunk of a generation task, built from the first batch

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
        (B,F,224,298,3) uint8 BGR, and optionally ``action`` and
        ``location`` (B,) int, repeated per frame; as numpy arrays or
        tensors."""
        as_tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        flat = {}
        for key in ("acoustic", "audio", "video"):
            t = as_tensor(raw[key])
            flat[key] = t.reshape(-1, *t.shape[2:]).to(self.device, non_blocking=True)
        frames = flat["audio"].shape[0] // raw["audio"].shape[0]
        for key in ("action", "location"):
            if key in raw:
                flat[key] = torch.as_tensor(as_tensor(raw[key])).repeat_interleave(frames).to(self.device)
        return preprocess_batch(flat["audio"], flat["video"], flat["acoustic"], flat.get("action"),
                                flat.get("location"), compute_mfcc=self.task.reads_mfcc)

    def _maybe_build_qtrunk(self, raw: dict) -> None:
        """With ``trunk_quant="int8"``, once: fold, quantize and calibrate the
        frozen trunk on the normalized frames of ``raw``."""
        if getattr(self.cfg, "trunk_quant", "none") != "int8" or self.qtrunk is not None:
            return
        video = torch.as_tensor(raw["video"])
        video = video.reshape(-1, *video.shape[2:]).to(self.device)
        self.qtrunk = self.task.build_qtrunk(normalize_video(video))

    def _noise(self, step: int, eps):
        """``(eps tensor, None)`` when the noise is given, else ``(None, the
        step's generator)``."""
        if eps is None:
            return None, step_generator(self.cfg.seed, step, self.device)
        return torch.as_tensor(np.array(eps, np.float32), device=self.device), None

    def train_step(self, state: TrainState, raw: dict, *, eps=None, moddrop=None) -> tuple[TrainState, dict]:
        """One step: prepare, loss and grads, TF1 Adam, BN statistics
        updated. ``eps`` replaces the step's noise: (frames, 150) for the
        generation task, (seconds, latent_dim) for the embedding task, whose
        ``moddrop`` (keep flags of video, audio, acoustic) replaces the
        moddrop draws. Returns the state (updated in place, step advanced)
        and the loss terms as detached f32 scalars."""
        self._maybe_build_qtrunk(raw)
        eps, generator = self._noise(state.step, eps)
        with no_tf32():
            batch = self._prepare(raw)
            total, metrics = self.task.loss(batch, eps=eps, generator=generator, qtrunk=self.qtrunk,
                                            moddrop=moddrop)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def eval_step(self, state: TrainState, raw: dict, *, eps=None) -> tuple[dict, torch.Tensor]:
        """Eval of one batch through the trunk the steps use: the per-frame
        losses of ``GenerationTask.eval_losses`` summed over the frames of
        the first ``raw["valid"]`` clips (all clips when absent; a padded
        remainder batch). Returns ``({name: f32 sum}, frames counted)``.
        Without the correspondence augmentation a batch is one half. The
        embedding task's eval step is not ported."""
        if isinstance(self.task, EmbedTask):
            raise NotImplementedError("Trainer.eval_step is not ported for the embedding task")
        self._maybe_build_qtrunk(raw)
        eps, generator = self._noise(state.step, eps)
        with torch.no_grad():
            batch = self._prepare(raw)
            losses, _ = self.task.eval_losses(batch, eps=eps, generator=generator, qtrunk=self.qtrunk)
        n_total = batch.video.shape[0]
        clips = raw["video"].shape[0]
        valid = raw.get("valid", clips)
        per_clip = n_total // clips
        mask = (torch.arange(n_total, device=self.device) < valid * per_clip).float()
        return {k: torch.sum(v * mask) for k, v in losses.items()}, torch.sum(mask)
