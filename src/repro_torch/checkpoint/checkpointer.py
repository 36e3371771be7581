"""Async checkpointing.

Counterpart of :mod:`repro.checkpoint.checkpointer`, on the same on-disk
layout: ``<dir>/step_<n>/{manifest.json, arrays.npz}``, leaves keyed by
their path joined with ``|``, written on a background thread under a
``.tmp`` name and committed by an atomic rename, the oldest steps pruned
past ``keep``.  So a checkpoint written by the reference restores here and
the reverse (float32, int32 and int8 leaves).  A bfloat16 leaf is written
as its ``uint16`` bits with ``bfloat16`` as its dtype in the manifest (no
``ml_dtypes`` is needed to read or write it).  ``save`` takes its host
copies before it returns, so the in-place optimizer may go on at once.
``restore`` departs from the reference: it writes the checkpoint into the
template's leaves in place, one leaf read at a time, so a restore holds no
second copy of the state (the reference returns new arrays).  The
reference's ``shardings=`` (restore onto another mesh) belongs to sharding,
ROADMAP item 7.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_items

Tree = Any

_BF16 = "bfloat16"


def _host(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a host numpy array of its own (bf16 as its uint16 bits):
    ``.cpu()`` of a CPU tensor is the tensor itself, which the optimizer
    updates in place while the writer thread reads it, so it is cloned."""
    t = leaf.detach().cpu()
    if leaf.device.type == "cpu":
        t = t.clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree: Tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """``{path: host array}`` and ``{path: dtype name}`` of every leaf."""
    flat, dtypes = {}, {}
    for key, leaf in tree_items(tree):
        flat[key] = _host(leaf)
        dtypes[key] = _BF16 if leaf.dtype == torch.bfloat16 else str(flat[key].dtype)
    return flat, dtypes


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Tree, metadata: Optional[Dict] = None):
        """Write ``state`` as step ``step``; the host copies happen on the
        caller's thread, the file writes on a background one (``wait``
        joins it) unless ``async_save`` is off.  A save in flight is joined
        before the copies are taken, so the host holds one copy at a time
        (the reference copies first)."""
        self.wait()
        flat, dtypes = _flatten(state)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, dtypes, metadata or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, dtypes, metadata or {})

    def _write(self, step: int, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
               metadata: Dict):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: [list(v.shape), dtypes[k]] for k, v in flat.items()},
            **metadata,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Tree, step: Optional[int] = None) -> Tuple[int, Tree]:
        """``(step, template)``: the checkpoint of ``step`` (the latest when
        None) copied into ``template``'s leaves in place, each in the
        template leaf's device and dtype.  Waits for a save in flight."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        with np.load(os.path.join(path, "arrays.npz")) as z, torch.no_grad():
            for key, leaf in tree_items(template):
                arr = z[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, the "
                                     f"template's {tuple(leaf.shape)}")
                if leaves[key][1] == _BF16:
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                leaf.copy_(t)
        return step, template
