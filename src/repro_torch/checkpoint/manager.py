"""Step checkpoints for resumable fits (counterpart of
``repro/checkpoint/manager.py``, without JAX).

- one directory per step, ``step_<n>/``: one ``.npy`` per leaf of a nested
  dict / list tree of arrays (leaves keyed by their '/'-joined paths) plus
  ``manifest.json`` with each leaf's key, shape and dtype;
- atomic publish: everything is written to ``step_<n>.tmp`` and then
  renamed, so a crash mid-save never corrupts the latest checkpoint;
- asynchronous save: one background thread writes while training goes on
  (the arrays are pulled to the host before ``save`` returns; ``wait()``
  joins, and every save first waits for the one before);
- retention: the last ``keep`` steps.

The JAX manager's sharded restore (``restore`` onto a mesh) has no
counterpart: the port runs on one card.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.sampling.store import flatten_tree, unflatten_tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree) -> None:
        """Snapshot ``tree`` (nested dicts / lists of arrays or tensors)."""
        self.wait()
        host = [(key, np.array(arr))          # a copy: the caller may mutate
                for key, arr in flatten_tree(_to_numpy(tree)).items()]

        def write():
            tmp = self._step_dir(step) + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": [], "time": time.time()}
            for i, (key, arr) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append({"key": key, "file": fn,
                                           "shape": list(arr.shape),
                                           "dtype": str(arr.dtype)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore_tree(self, step: Optional[int] = None):
        """Rebuild a checkpoint from its manifest alone: '/'-joined keys are
        re-nested into dicts, digit-only levels into lists.  Returns
        (tree, step)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {leaf["key"]: np.load(os.path.join(d, leaf["file"]))
                for leaf in manifest["leaves"]}
        return unflatten_tree(flat), step


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if hasattr(tree, "detach"):                       # a torch tensor
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
