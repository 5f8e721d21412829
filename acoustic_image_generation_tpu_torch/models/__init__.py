"""The port's model zoo, named as the JAX package's ``models`` exports them.

Every module takes and returns NHWC, holds f32 master parameters and
computes in its ``dtype``; module paths mirror the flax scopes
(``bridge.py`` carries the trees across).
"""

from acoustic_image_generation_tpu_torch.models.decoders import (
    DecoderAudio,
    DecoderEnergy,
    DecoderVideo,
    MeanStd,
)
from acoustic_image_generation_tpu_torch.models.dualcamnet import DualCamNet
from acoustic_image_generation_tpu_torch.models.resnet import ResNet50
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic, UNetAcResNet
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetEnergy, UNetVideo, UNetVideoSkip
from acoustic_image_generation_tpu_torch.models.vggish import VGGish

__all__ = [
    "DecoderAudio",
    "DecoderEnergy",
    "DecoderVideo",
    "MeanStd",
    "DualCamNet",
    "ResNet50",
    "UNetAcoustic",
    "UNetAcResNet",
    "UNetSound",
    "UNetVideo",
    "UNetVideoSkip",
    "UNetEnergy",
    "VGGish",
]
