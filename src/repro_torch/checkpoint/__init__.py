"""Checkpoints of the training path (``checkpoint.checkpointing``)."""
