"""Dataclass base for the port's tensor bundles (the JAX pytrees)."""

from __future__ import annotations

import dataclasses


class Struct:
    """Mixin for ``@dataclasses.dataclass`` bundles of tensors: adds the
    functional ``replace`` the JAX pytree dataclasses have."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
