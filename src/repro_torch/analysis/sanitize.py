"""Runtime sanitizers of the port, counterpart of
``repro/analysis/sanitize.py``.

- :func:`recompile_guard`: a context manager that snapshots the kernel
  library's build counter (:func:`repro_torch.kernels.builds`, one count
  per build or load of the library) and raises :class:`RecompileError`
  when the guarded region built more than its budget (0 on warm serving
  and training paths).  The port runs its kernels eagerly and has no
  other executables to count: the JAX package counts its sweep and train
  executables here.
- :func:`check_finite` / :func:`nan_tripwire`: a NaN/inf tripwire that
  walks result trees (dicts, sequences, dataclasses such as
  ``SamplingPlan``, numpy arrays and torch tensors) and raises
  :class:`NonFiniteError` naming the offending path.
  ``PlanService(..., sanitize=True)`` wires it into the dispatcher.

The tripwire reads a CUDA tensor back to the host (one sync a tensor):
that is the sanitizer's cost, so keep it off hot paths.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


class RecompileError(RuntimeError):
    """A guarded region built more than its budget."""


class NonFiniteError(ValueError):
    """A guarded result contained NaN or inf."""


@dataclasses.dataclass
class GuardStats:
    """Filled in when the :func:`recompile_guard` block exits: the kernel
    library's builds inside the block."""

    builds: int = 0


@contextlib.contextmanager
def recompile_guard(max_builds: int = 0, *,
                    label: str = "warm path") -> Iterator[GuardStats]:
    """Assert the region builds or loads the kernel library at most
    ``max_builds`` times::

        service.warmup(buckets)
        with recompile_guard():          # 0 new builds allowed
            service.plan(x, seqs)
    """
    from repro_torch import kernels

    start = kernels.builds()
    stats = GuardStats()
    try:
        yield stats
    finally:
        stats.builds = kernels.builds() - start
    if stats.builds > max_builds:
        raise RecompileError(
            f"recompile guard tripped on {label}: {stats.builds} kernel "
            f"library build(s) exceed the budget of {max_builds}; warm the "
            f"engine first (PlanEngine.warmup) or raise max_builds")


def _is_float_leaf(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() or x.is_complex()
    dtype = getattr(x, "dtype", None)
    if dtype is None:
        return isinstance(x, float)
    try:
        return np.issubdtype(np.dtype(dtype), np.inexact)
    except TypeError:
        return False


def _walk(obj: Any, path: str, seen: set) -> Iterator[tuple]:
    if id(obj) in seen:
        return
    if isinstance(obj, dict):
        seen.add(id(obj))
        for k, v in obj.items():
            yield from _walk(v, f"{path}[{k!r}]", seen)
    elif isinstance(obj, (list, tuple)):
        seen.add(id(obj))
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]", seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        seen.add(id(obj))
        for f in dataclasses.fields(obj):
            yield from _walk(getattr(obj, f.name), f"{path}.{f.name}", seen)
    elif _is_float_leaf(obj):
        yield path, obj


def check_finite(obj: Any, name: str = "result") -> None:
    """Raise :class:`NonFiniteError` if any float leaf of ``obj`` holds
    NaN/inf.  Walks dicts, sequences, dataclasses, numpy arrays and torch
    tensors (a CUDA tensor's count is read back to the host)."""
    for path, leaf in _walk(obj, name, set()):
        if isinstance(leaf, torch.Tensor):
            size = leaf.numel()
            bad = int(size - torch.isfinite(leaf.detach()).sum()) if size \
                else 0
            dtype, shape = leaf.dtype, tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            size = arr.size
            bad = int(size - np.isfinite(arr).sum()) if size else 0
            dtype, shape = arr.dtype, arr.shape
        if bad:
            raise NonFiniteError(
                f"non-finite values in {path}: {bad}/{size} element(s) "
                f"are NaN/inf (dtype={dtype}, shape={shape})")


def nan_tripwire(fn: Optional[Callable] = None, *,
                 name: Optional[str] = None) -> Callable:
    """Wrap a callable so its return value is checked by
    :func:`check_finite`.  Usable bare or as a decorator::

        plan = nan_tripwire(engine.plan_many)
        @nan_tripwire
        def fit(...): ...
    """
    if fn is None:
        return functools.partial(nan_tripwire, name=name)
    label = name or getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        check_finite(out, name=f"{label}(...)")
        return out

    return wrapped
