"""Device meshes of the port: one card (counterpart of
``repro/launch/mesh.py``).

JAX's production mesh is 16 x 16 (data, model) TPU chips, or 2 x 16 x 16
with a pod axis.  The port runs on one card, so its production mesh is that
card, (1, 1) over ("data", "model"); a mesh wider than the cards present,
or the multi-pod mesh, raises and names ROADMAP A9b (data parallelism and
model sharding over several cards).  A ``Mesh`` describes devices and
places nothing: the port has no sharding (``distributed/sharding.py`` is
not ported, so JAX's ``make_rules`` and its ``MeshRules`` come with A9b).
Functions, not module constants: importing this module touches no device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

AXES = ("data", "model")


class Mesh(NamedTuple):
    shape: tuple
    axes: tuple
    devices: tuple   # torch.device, data-major

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(device_type: str = "cuda") -> list:
    """The devices a mesh may hold, in order: the cards present, or the
    CPU as one device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"repro_torch runs on cuda or cpu, not {device_type}")


def widths(device_type: str = "cuda") -> range:
    """The data-parallel widths a mesh over ``device_type`` may have: 1 up
    to the devices present."""
    return range(1, len(visible_devices(device_type)) + 1)


def _mesh(shape: tuple, device_type: str) -> Mesh:
    n = 1
    for s in shape:
        n *= s
    present = visible_devices(device_type)
    if not 1 <= n <= len(present):
        raise ValueError(
            f"a {shape} mesh needs {n} devices; {len(present)} "
            f"{device_type} present (meshes over several cards are ROADMAP "
            f"A9b)")
    return Mesh(tuple(shape), AXES, tuple(present[:n]))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The mesh a cell runs on: the one card.  ``multi_pod`` raises."""
    if multi_pod:
        raise NotImplementedError(
            "multi_pod: the port's production mesh is one card; a pod axis "
            "over several cards is ROADMAP A9b")
    return Mesh((1, 1), AXES, (torch.device("cuda", 0),))


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda") -> Mesh:
    """A (data, model) mesh over the first data x model devices present;
    raises ValueError above those present."""
    return _mesh((data, model), device_type)


def make_data_mesh(ndev: int = 0, *, device_type: str = "cuda") -> Mesh:
    """An (ndev, 1) mesh over the FIRST ``ndev`` devices present, in order
    (0 = all), as JAX's ``make_data_mesh`` builds every scale-out width so
    that a degraded width is a prefix of the wider one; raises ValueError
    above those present."""
    n = int(ndev) or len(visible_devices(device_type))
    return _mesh((n, 1), device_type)
