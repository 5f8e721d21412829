"""Experiment configuration and the checkpoint wire format: the
counterparts of the JAX package's ``core/config.py`` and of the part of
``flax.serialization`` its checkpoints use."""
