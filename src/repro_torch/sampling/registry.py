"""Copy of ``repro/sampling/registry.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

String-keyed registry of sampling methods (gcl / pka / sieve / stem_root).

Built on :class:`repro_torch.utils.registry.Registry`.  Method classes register
themselves in :mod:`repro_torch.sampling.methods`, which is imported lazily here
so that core modules can depend on :mod:`repro_torch.sampling.base` without a
circular import.
"""

from __future__ import annotations

from typing import Type

from repro_torch.sampling.base import SamplingMethod
from repro_torch.utils.registry import Registry

SAMPLING_METHODS: Registry = Registry("sampling method")


def register_method(cls: Type[SamplingMethod]) -> Type[SamplingMethod]:
    """Class decorator: register under the class's ``id``."""
    if not cls.id:
        raise ValueError(f"{cls.__name__} must set a non-empty `id`")
    SAMPLING_METHODS.add(cls.id, cls)
    return cls


def _ensure_loaded() -> None:
    import repro_torch.sampling.methods  # noqa: F401  (registration side effect)


def available_methods() -> list[str]:
    _ensure_loaded()
    return SAMPLING_METHODS.names()


def get_method(name: str, **kwargs) -> SamplingMethod:
    """Instantiate a registered method: ``get_method("gcl", steps=40)``.

    kwargs are forwarded to the method class constructor; every class
    accepts keyword-only overrides of its defaults.
    """
    _ensure_loaded()
    cls = SAMPLING_METHODS.get(name)
    return cls(**kwargs)
