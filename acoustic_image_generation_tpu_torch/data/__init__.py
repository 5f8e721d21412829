"""Host input path (TFRecord shards -> ``RawBatch``es) and device
preprocessing. Importing the package loads numpy-only modules; the ingest
library is built at a loader's first use."""

from acoustic_image_generation_tpu_torch.data.pipeline import AcousticImageDataLoader, RawBatch
from acoustic_image_generation_tpu_torch.data.synthetic import write_synthetic_dataset

__all__ = ["AcousticImageDataLoader", "RawBatch", "write_synthetic_dataset"]
