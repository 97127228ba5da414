"""String-keyed field registry for cross-module coupling.

Reference: ``source/named_field_mod.F90`` — modules register named fields
(``named_field_register``) and other modules look them up and get/set
values without compile-time coupling (used e.g. for ecosystem <-> coupler
exchange fields). Here: a registry of tensors with shape checking; host-side
bookkeeping (values are exchanged between modules between steps, or threaded
explicitly through ``Forcing``)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class NamedFieldRegistry:
    def __init__(self):
        self._fields: Dict[str, Optional[torch.Tensor]] = {}
        self._shapes: Dict[str, Tuple[int, ...]] = {}

    def register(self, name: str, shape: Tuple[int, ...]) -> None:
        """named_field_register (named_field_mod.F90:126)."""
        if name in self._fields and self._shapes[name] != tuple(shape):
            raise ValueError(f"field {name} already registered with shape "
                             f"{self._shapes[name]}")
        self._shapes[name] = tuple(shape)
        self._fields.setdefault(name, None)

    def get_index(self, name: str) -> str:
        """named_field_get_index: the name itself is the handle."""
        if name not in self._shapes:
            raise KeyError(f"named field {name} not registered")
        return name

    def set(self, name: str, value) -> None:
        """The field's value: a tensor as it is, host data as a CPU
        tensor."""
        value = torch.as_tensor(value)
        if tuple(value.shape) != self._shapes[name]:
            raise ValueError(
                f"field {name}: expected shape {self._shapes[name]}, "
                f"got {tuple(value.shape)}")
        self._fields[name] = value

    def get(self, name: str) -> torch.Tensor:
        v = self._fields.get(name)
        if v is None:
            raise KeyError(f"named field {name} has no value set")
        return v

    def registered(self, name: str) -> bool:
        return name in self._shapes
