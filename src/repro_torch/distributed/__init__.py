"""Distributed primitives of the port: the fault protocol (``fault.py``, a
verbatim copy of ``repro/distributed/fault.py``: standard library only),
the process group and its mesh subgroups (``group.py``), JAX's
``sharding.py`` restated (``sharding.py``: the data-parallel
``PACKED_BATCH_AXES`` / ``shard_batch``, and the parameter specs
``MeshRules`` / ``spec_for`` / ``param_specs``), and the LM step's
sharding over a (data, model) mesh of ranks (``model_parallel.py``).

The JAX package's ``distributed/__init__`` exports its mesh helpers
(``MeshRules``, ``constrain``, ``param_shardings``, ...); ``group``,
``sharding`` and ``model_parallel`` import ``torch.distributed``, the
batching code and the models, so they are imported from their modules,
not here.
"""

from repro_torch.distributed.fault import (
    DeviceLost, Heartbeat, Watchdog, retry,
)

__all__ = ["DeviceLost", "Heartbeat", "Watchdog", "retry"]
