"""The synthetic data pipeline: batches as a pure function of (seed, step)."""

from repro_torch.data.pipeline import Prefetcher, SyntheticLMDataset  # noqa: F401
