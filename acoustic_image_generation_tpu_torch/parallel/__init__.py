"""Data parallelism, FSDP and tensor parallelism over ``torch.distributed`` (``mesh.py``)."""
