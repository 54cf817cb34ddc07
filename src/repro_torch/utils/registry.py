"""Copy of ``repro/utils/registry.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Minimal name -> object registry used for archs, kernel templates, programs."""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._items:
                raise KeyError(f"duplicate {self.kind} registration: {name!r}")
            self._items[name] = obj
            return obj

        return deco

    def add(self, name: str, obj: T) -> None:
        if name in self._items:
            raise KeyError(f"duplicate {self.kind} registration: {name!r}")
        self._items[name] = obj

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"unknown {self.kind} {name!r}; known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self) -> list[str]:
        return sorted(self._items)

    def items(self) -> Iterator[tuple[str, T]]:
        return iter(sorted(self._items.items()))
