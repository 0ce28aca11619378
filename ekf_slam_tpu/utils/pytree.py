"""Frozen dataclasses that are JAX pytrees.

Every field is a child node (arrays, nested pytrees, or None), so instances
pass through jit, vmap, scan, tree_map and sharding as plain data, and
`.replace(**changes)` returns an updated copy."""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Class decorator: frozen dataclass + pytree registration (all fields
    are data) + a `.replace` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=fields, meta_fields=[])
