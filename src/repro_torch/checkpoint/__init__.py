"""Async checkpointing in the reference's on-disk layout."""

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
