"""Training state: the counterpart of ``acoustic_image_generation_tpu/
train/state.py::TrainState``.

JAX carries the step, the parameters, the BN statistics and the optimizer
state as one immutable pytree. Here the parameters and BN buffers live in
the task's modules and the Adam slots in the optimizer; the train step
updates them in place and advances ``step``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from acoustic_image_generation_tpu_torch.train.optim import Adam, TF1Adam


@dataclass
class TrainState:
    step: int
    task: torch.nn.Module  # params + BN running statistics
    optimizer: TF1Adam | Adam  # Adam slots of the trainable parameters only
