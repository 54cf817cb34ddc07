"""Fault-tolerance primitives of the port (``fault.py``, a verbatim copy of
``repro/distributed/fault.py``: standard library only).

The JAX package's ``distributed/__init__`` also exports its mesh helpers
(``sharding.py``: ``MeshRules``, ``constrain``, ``param_shardings``, ...).
They are JAX pytree and mesh code and are not ported, by design.
"""

from repro_torch.distributed.fault import (
    DeviceLost, Heartbeat, Watchdog, retry,
)

__all__ = ["DeviceLost", "Heartbeat", "Watchdog", "retry"]
