"""Plain dataclasses of tensors: the port's stand-in for flax.struct."""

from __future__ import annotations

import dataclasses

import torch


class TensorStruct:
    """Mixin for a frozen dataclass whose fields are tensors (or None, or
    plain Python values that stay as they are)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        """A copy with every tensor field moved to `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def nbytes(self) -> int:
        """Bytes held by the tensor fields."""
        return sum(
            t.numel() * t.element_size()
            for t in (getattr(self, f.name) for f in dataclasses.fields(self))
            if isinstance(t, torch.Tensor))
