"""PyTorch/CUDA port of ``acoustic_image_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here is
tested against its counterpart there on the CPU. This package imports
``torch`` and ``numpy`` only, never ``jax`` and nothing of the JAX package.

Subpackages mirror the JAX names:

dsp       MFCC frontend (plain torch) and the inverse energy map
ops       hand-written CUDA kernels (``csrc/``), their builder and wrappers
data      device preprocessing of raw audio/video frames
models    ResNet50 trunk (eval and train mode) and the UNetAcResNet generator
losses    reconstruction, KL and L2 terms
train     ``GenerationTask``, TF1 Adam and the generation train step

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``. With no GPU and no explicit device they raise; they never
carry on on the CPU by themselves.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

SPATIAL_H = 36
SPATIAL_W = 48
NUM_MFCC = 12
FRAMES_PER_SECOND = 12
NUM_SAMPLES_PER_FRAME = 1024
SAMPLE_RATE = 12288
VIDEO_H = 224
VIDEO_W = 298


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is asked for (explicitly or by default) and
    no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
