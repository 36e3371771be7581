"""Deterministic synthetic data pipeline.

Counterpart of :mod:`repro.data.pipeline` (the port keeps its own copy of
the numpy generator): every batch is a pure function of (seed, step) via
numpy Philox streams, so a restart reproduces the exact token stream and a
restored step re-sees its original batch, and the batches equal the
reference's bit for bit.  The "corpus" is a Zipf-distributed token stream
with locally-coherent spans.  :class:`Prefetcher` generates ahead on a
background thread and, given a device, places each batch there (pinned
host memory and a non-blocking copy for a CUDA device).  The reference's
``make_batch_specs`` is its dry-run's (ROADMAP item 9).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class SyntheticLMDataset:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        zipf_a: float = 1.2,
        modality: Optional[Dict[str, tuple]] = None,  # extra float inputs
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a
        self.modality = modality or {}

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.Philox(key=self.seed, counter=step))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}`` int32 ``(B, S)`` (labels the next
        tokens) and each modality input, float32 ``(B,) + shape``."""
        rng = self._rng(step)
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # zipf over a shuffled alias of the vocab; clipped into range
        raw = rng.zipf(self.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = (raw * 2654435761) % V  # hash spreads hot ids across the table
        # locally-coherent spans: repeat the previous token with p=0.2
        rep = rng.random((B, S + 1)) < 0.2
        for j in range(1, S + 1):
            toks[:, j] = np.where(rep[:, j], toks[:, j - 1], toks[:, j])
        out = {
            "tokens": toks[:, :S].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        for name, shape in self.modality.items():
            out[name] = rng.normal(size=(B,) + shape).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: through pinned memory and a
    non-blocking copy for a CUDA device (the copy is ordered on the stream
    before any later work that reads it)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


class Prefetcher:
    """Background-thread prefetch of batches: host numpy batches, or with
    ``device`` tensors already placed there."""

    def __init__(self, dataset: SyntheticLMDataset, depth: int = 2, start_step: int = 0,
                 device=None):
        self._ds = dataset
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._device = device
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._ds.batch(step)
            if self._device is not None:
                batch = to_device(batch, self._device)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        """``(step, batch)`` of the next step, in order."""
        return self._q.get()

    def close(self):
        """Stop the thread (it exits within 0.1 s of a full queue)."""
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
