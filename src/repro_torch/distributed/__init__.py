"""Distributed primitives of the port: the fault protocol (``fault.py``, a
verbatim copy of ``repro/distributed/fault.py``: standard library only),
the process group of the data-parallel fit (``group.py``) and the
data-parallel half of JAX's ``sharding.py`` (``sharding.py``:
``PACKED_BATCH_AXES``, ``shard_batch``).

The JAX package's ``distributed/__init__`` exports its mesh helpers
(``MeshRules``, ``constrain``, ``param_shardings``, ...), the parameter
half of its ``sharding.py``, which comes with LM model sharding (ROADMAP
A9c).  ``group`` and ``sharding`` import ``torch.distributed`` and the
batching code, so they are imported from their modules, not here.
"""

from repro_torch.distributed.fault import (
    DeviceLost, Heartbeat, Watchdog, retry,
)

__all__ = ["DeviceLost", "Heartbeat", "Watchdog", "retry"]
