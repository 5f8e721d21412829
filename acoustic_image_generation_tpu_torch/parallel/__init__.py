"""Data parallelism and FSDP over ``torch.distributed`` (``mesh.py``)."""
