"""Device resolution shared by every entry point of the port.

``None`` means the card: entry points run on ``cuda`` unless the caller asks
for the CPU explicitly, and they raise instead of carrying on on the CPU
when no card is present.

Staging (``HostStager``, ``take``) moves host arrays onto the device from a
worker thread: pinned memory, one copy stream a device, an event the
consumer's stream waits on.
"""

from __future__ import annotations

import functools
import threading
from collections import deque
from typing import NamedTuple, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/"cuda[:i]" -> a CUDA device (raises without one); "cpu" ->
    the CPU.  On CUDA, float32 matmuls and convolutions are pinned to full
    float32 (TF32 off, both switches set explicitly) so the encoder's
    ``torch.matmul`` products keep float32 precision on the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch path explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that carries staged uploads."""
    return torch.cuda.Stream(device)


class Staged(NamedTuple):
    """Tensors a :class:`HostStager` put on a device: usable on the
    consuming thread's stream after :func:`take`.  ``event`` is ``None``
    on the CPU, where nothing is in flight."""
    tensors: dict
    event: Optional["torch.cuda.Event"]


class HostStager:
    """Host arrays -> tensors on ``device``, callable from a worker thread
    (the one-ahead staging of ``core/train._OneAhead``).

    On the card: each array is copied into pinned memory (``pin_memory``,
    PyTorch's caching host allocator), then copied to the device with
    ``non_blocking`` copies on the device's one copy stream, and an event is
    recorded after them.  The consumer's :func:`take` makes its stream wait
    for that event and marks every tensor as used there.  A failed pin or
    copy raises: there is no pageable, synchronous fallback.  The pinned
    sources stay referenced here until their event has passed.  On the
    CPU a put is ``torch.from_numpy`` (the arrays are shared, not copied).
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._inflight: deque = deque()    # (event, pinned sources)
        self._lock = threading.Lock()

    def put(self, arrays: dict) -> Staged:
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in arrays.items()}
        if self.device.type != "cuda":
            return Staged(host, None)
        with torch.cuda.device(self.device):
            stream = _copy_stream(self.device)
            pinned = {k: t.pin_memory() for k, t in host.items()}
            with torch.cuda.stream(stream):
                out = {k: t.to(self.device, non_blocking=True)
                       for k, t in pinned.items()}
                event = torch.cuda.Event()
                event.record(stream)
        with self._lock:
            while self._inflight and self._inflight[0][0].query():
                self._inflight.popleft()
            self._inflight.append((event, pinned))
        return Staged(out, event)


def take(staged: Staged) -> dict:
    """The staged tensors, ready for the calling thread's current stream:
    the stream waits for the copies' event (on the device, not the host),
    and each tensor is recorded as used by it, so the caching allocator
    does not hand its memory to the copy stream while compute still reads
    it."""
    if staged.event is None:
        return staged.tensors
    some = next(iter(staged.tensors.values()), None)
    if some is None:
        return staged.tensors
    cur = torch.cuda.current_stream(some.device)
    cur.wait_event(staged.event)
    for t in staged.tensors.values():
        t.record_stream(cur)
    return staged.tensors
