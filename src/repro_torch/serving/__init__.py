"""Continuous-batching serving of dense transformers (PyTorch)."""
