"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``).

JAX's production mesh is 16 x 16 (data, model) TPU chips, or 2 x 16 x 16
with a pod axis.  The port shards data, not models: its data-parallel
width is the ranks of a ``torch.distributed`` group
(:class:`~repro_torch.distributed.group.Group`, one process a rank), or,
without a group, the cards present, which the plan engine places a sweep
dispatch's programs across.  ``make_data_mesh`` and ``widths`` count the
group's ranks when one is given and the cards present otherwise; a wider
mesh raises.  The production mesh of an LM cell is one card, (1, 1) over
("data", "model"): model sharding and the pod axis (JAX's ``make_rules``
and its ``MeshRules`` parameter specs) are ROADMAP A9c, and the multi-pod
mesh raises naming it.  A ``Mesh`` describes devices or ranks and places
nothing.  Functions, not module constants: importing this module touches
no device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

AXES = ("data", "model")


class Mesh(NamedTuple):
    shape: tuple
    axes: tuple
    devices: tuple   # torch.device, data-major; () for a mesh of ranks
    ranks: tuple = ()  # the group ranks of a mesh of ranks, in order

    @property
    def size(self) -> int:
        return len(self.ranks) or len(self.devices)


def visible_devices(device_type: str = "cuda") -> list:
    """The devices a mesh may hold, in order: the cards present, or the
    CPU as one device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"repro_torch runs on cuda or cpu, not {device_type}")


def widths(device_type: str = "cuda", group=None) -> range:
    """The data-parallel widths a mesh may have: 1 up to the ranks of
    ``group``, or without one the ``device_type`` devices present."""
    if group is not None:
        return range(1, group.size + 1)
    return range(1, len(visible_devices(device_type)) + 1)


def _mesh(shape: tuple, device_type: str) -> Mesh:
    n = 1
    for s in shape:
        n *= s
    present = visible_devices(device_type)
    if not 1 <= n <= len(present):
        raise ValueError(
            f"a {shape} mesh needs {n} devices; {len(present)} "
            f"{device_type} present (a data-parallel width above the cards "
            f"runs over the ranks of a group: group=, ROADMAP A9b)")
    return Mesh(tuple(shape), AXES, tuple(present[:n]))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The mesh a cell runs on: the one card.  ``multi_pod`` raises."""
    if multi_pod:
        raise NotImplementedError(
            "multi_pod: the port's production mesh is one card; model "
            "sharding and a pod axis over several cards are ROADMAP A9c")
    return Mesh((1, 1), AXES, (torch.device("cuda", 0),))


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda") -> Mesh:
    """A (data, model) mesh over the first data x model devices present;
    raises ValueError above those present."""
    return _mesh((data, model), device_type)


def make_data_mesh(ndev: int = 0, *, device_type: str = "cuda",
                   group=None) -> Mesh:
    """An (ndev, 1) mesh over the FIRST ``ndev`` ranks of ``group`` or,
    without one, devices present, in order (0 = all), as JAX's
    ``make_data_mesh`` builds every scale-out width so that a degraded
    width is a prefix of the wider one; raises ValueError above those
    present."""
    if group is None:
        n = int(ndev) or len(visible_devices(device_type))
        return _mesh((n, 1), device_type)
    n = int(ndev) or group.size
    if not 1 <= n <= group.size:
        raise ValueError(f"a ({n}, 1) mesh needs {n} ranks; the group has "
                         f"{group.size} (ROADMAP A9b)")
    return Mesh((n, 1), AXES, (), tuple(range(n)))
