"""Frozen dataclasses of tensors: the containers behind Grid, State, Forcing.

``TensorTree`` gives a dataclass ``.to(device)`` (every tensor leaf moved,
nested trees followed, everything else kept) and ``.replace(**fields)``.
"""

from __future__ import annotations

import dataclasses

import torch


class TensorTree:
    """Mixin for ``@dataclass(frozen=True)`` containers of tensors."""

    def to(self, device):
        def move(v):
            if isinstance(v, (torch.Tensor, TensorTree)):
                return v.to(device)
            return v
        return type(self)(**{f.name: move(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def leaves(self):
        """(name, tensor) pairs of the tensor leaves, nested names dotted."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out.append((f.name, v))
            elif isinstance(v, TensorTree):
                out.extend((f"{f.name}.{n}", t) for n, t in v.leaves())
        return out
