"""Device meshes of the port (counterpart of ``repro/launch/mesh.py``).

JAX's production mesh is 16 x 16 (data, model) TPU chips, or 2 x 16 x 16
with a pod axis first.  The port runs one process a rank, joined by a
``torch.distributed`` group (:class:`~repro_torch.distributed.group.Group`),
so a mesh of several devices is a mesh of the group's ranks, laid over
them data-major (rank ``(d, m)`` of a (data, model) mesh is group rank
``d * model + m``; with a pod axis ``(p * data + d) * model + m``).
``make_production_mesh(group=)`` and ``make_debug_mesh(data, model,
group=)`` build such meshes; JAX's shapes stay, and a group of another
size raises, naming the ranks the mesh needs (nothing is reshaped to
fit).  ``make_rules`` is JAX's: batch axes ``("pod", "data")`` with the
pod axis, else ``("data",)``.  Without a group the meshes hold the cards
(or the CPU) present: the production mesh of a one-card run is (1, 1),
the default, and ``make_data_mesh`` / ``widths`` count the cards a sweep
dispatch is placed across.  A ``Mesh`` describes devices or ranks and
places nothing (``distributed/model_parallel.py`` places the params).
Functions, not module constants: importing this module touches no device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
#: JAX's production mesh shapes
POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


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


def rank_mesh(shape: tuple, axes: tuple = AXES) -> Mesh:
    """A mesh of ``shape`` over ranks 0 .. n-1 of a group, data-major."""
    n = 1
    for s in shape:
        n *= s
    return Mesh(tuple(shape), tuple(axes), (), tuple(range(n)))


def _group_mesh(shape: tuple, axes: tuple, group, exact: bool) -> Mesh:
    mesh = rank_mesh(shape, axes)
    if (group.size != mesh.size) if exact else (group.size < mesh.size):
        raise ValueError(
            f"a {tuple(shape)} mesh over {tuple(axes)} needs a group of "
            f"{mesh.size} ranks; this one has {group.size}")
    return mesh


def make_production_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """JAX's production mesh over the ranks of ``group``: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model") with
    ``multi_pod``; a group of another size raises.  Without a group, the
    one card (1, 1) (``multi_pod`` then raises: it needs 512 ranks)."""
    shape, axes = ((MULTIPOD_SHAPE, POD_AXES) if multi_pod
                   else (POD_SHAPE, AXES))
    if group is not None:
        return _group_mesh(shape, axes, group, exact=True)
    if multi_pod:
        raise ValueError(f"multi_pod: a {shape} mesh over {axes} needs a "
                         f"group of {rank_mesh(shape, axes).size} ranks "
                         f"(group=)")
    return Mesh((1, 1), AXES, (torch.device("cuda", 0),))


def make_rules(mesh: Mesh, *, multi_pod: bool = False, **kw):
    """JAX's ``make_rules``: ``MeshRules`` with the batch axes ("pod",
    "data") on the multi-pod mesh, else ("data",)."""
    from repro_torch.distributed.sharding import MeshRules

    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return MeshRules(mesh=mesh, batch_axes=batch_axes, **kw)


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda", group=None) -> Mesh:
    """A (data, model) mesh over the first data x model ranks of
    ``group`` or, without one, devices present; raises ValueError above
    those present."""
    if group is not None:
        return _group_mesh((data, model), AXES, group, exact=False)
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
