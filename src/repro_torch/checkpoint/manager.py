"""Step checkpoints for resumable fits and LM training (counterpart of
``repro/checkpoint/manager.py``, without JAX).

- one directory per step, ``step_<n>/``: one ``.npy`` per leaf of a nested
  dict / list / NamedTuple tree of arrays or tensors (leaves keyed by their
  '/'-joined paths; a NamedTuple's ``None`` fields have no leaves, as in
  JAX's tree) plus ``manifest.json`` with each leaf's key, shape and dtype;
  a bfloat16 tensor is stored as its 16-bit pattern (numpy has no
  bfloat16) under the dtype ``bfloat16``;
- atomic publish: everything is written to ``step_<n>.tmp`` and then
  renamed, so a crash mid-save never corrupts the latest checkpoint;
- asynchronous save: one background thread writes while training goes on
  (the arrays are pulled to the host before ``save`` returns; ``wait()``
  joins, and every save first waits for the one before);
- retention: the last ``keep`` steps.

``restore(like)`` rebuilds a tree shaped like ``like`` (a ``TrainState``
whose leaves give each leaf's dtype, e.g. on the ``meta`` device) with
every leaf in its dtype on the requested device, bit for bit.
``restore_tree`` needs no ``like``: bfloat16 leaves come back widened to
float32, exactly.

A ``TrainState`` sharded over a mesh of ranks (``save(...,
sharding=)``, a ``distributed/model_parallel.Sharding``) is saved whole:
every rank gathers it leaf by leaf, rank 0 writes it in the one-card
format (and waits for the write), and every rank passes a barrier after
the save.  ``restore(..., sharding=)`` reads the whole leaves and slices
this rank's blocks out of them, so a checkpoint moves across mesh shapes
(and to and from one card): the port's counterpart of JAX's elastic
restore onto other shardings.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.sampling.store import unflatten_tree

BF16 = "bfloat16"


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

    def save(self, step: int, tree, *, sharding=None) -> None:
        """Snapshot ``tree`` (nested dicts / lists / NamedTuples of arrays
        or tensors).  The leaves are copied to the host before this
        returns: the caller may update them in place.  With ``sharding``
        (every rank calls it), ``tree`` is this rank's blocks of a
        ``TrainState``: rank 0 writes the whole state before the ranks'
        barrier."""
        if sharding is not None:
            whole = sharding.gather_state(tree)
            if whole is not None:
                self.save(step, whole)
                self.wait()
            sharding.barrier()
            return
        self.wait()
        host = list(_host_leaves(tree).items())

        def write():
            tmp = self._step_dir(step) + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": [], "time": time.time()}
            for i, (key, (arr, dtype)) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append({"key": key, "file": fn,
                                           "shape": list(arr.shape),
                                           "dtype": dtype})
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
        flat = {}
        for leaf in manifest["leaves"]:
            arr = np.load(os.path.join(d, leaf["file"]))
            if leaf["dtype"] == BF16:          # exact: bf16 is f32's top half
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            flat[leaf["key"]] = arr
        return unflatten_tree(flat), step

    def restore(self, like, step: Optional[int] = None, *, device=None,
                sharding=None):
        """Rebuild ``like``'s tree (dicts, lists and NamedTuples such as
        ``TrainState``) from disk: tensor leaves in ``like``'s dtypes on
        ``device`` (default the CPU), int leaves as ints.  Returns (tree,
        step); raises FileNotFoundError without a checkpoint.  With
        ``sharding``, ``like`` is the whole state and the result this
        rank's blocks of it."""
        if sharding is not None:
            whole, step = self.restore(like, step)
            return sharding.slice_state(whole, device), step
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}

        def load(key, ref):
            meta = by_key[key]
            arr = np.load(os.path.join(d, meta["file"]))
            shape = tuple(getattr(ref, "shape", ()))
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint leaf {key} shape {arr.shape} "
                                 f"!= {shape}")
            if not isinstance(ref, torch.Tensor):
                return type(ref)(arr)
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if meta["dtype"] == BF16 else torch.from_numpy(arr))
            return t.to(device=device, dtype=ref.dtype)

        def build(node, prefix):
            if hasattr(node, "_asdict"):
                return type(node)(**{
                    k: None if v is None else build(v, f"{prefix}{k}/")
                    for k, v in node._asdict().items()})
            if isinstance(node, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            return load(prefix.rstrip("/"), node)

        return build(like, ""), step


def _host_leaves(tree, prefix: str = "") -> dict:
    """{'/'-joined key: (host array, dtype name)}, every leaf a copy."""
    if hasattr(tree, "_asdict"):                      # a NamedTuple
        tree = {k: v for k, v in tree._asdict().items() if v is not None}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"tree key {k!r} contains '/'")
            out.update(_host_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_host_leaves(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out[prefix.rstrip("/")] = (
                t.view(torch.int16).numpy().view(np.uint16), BF16)
        else:
            arr = t.numpy()
            out[prefix.rstrip("/")] = (arr, str(arr.dtype))
    else:
        arr = np.array(tree)
        out[prefix.rstrip("/")] = (arr, str(arr.dtype))
    return out
