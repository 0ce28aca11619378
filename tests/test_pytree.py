"""The local pytree dataclass helper (utils/pytree.py) that carries the
filter state and the per-frame records: every class built on it must pass
through jit, vmap, tree_map and `.replace` as data."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ekf_slam_tpu.utils import pytree

CLASSES = [
    ("ekf_slam_tpu.filter.state", "FilterState"),
    ("ekf_slam_tpu.filter.engine", "StepInfo"),
    ("ekf_slam_tpu.filter.engine", "Phase1Carry"),
    ("ekf_slam_tpu.sim.scene", "Scene"),
    ("ekf_slam_tpu.sim.scene", "FrameObs"),
    ("ekf_slam_tpu.vision.frontend", "Appearance"),
    ("ekf_slam_tpu.vision.frontend", "ImagePhase1Carry"),
    ("ekf_slam_tpu.models.loopclosure", "LoopDatabase"),
    ("ekf_slam_tpu.models.train", "TrainState"),
]


def _instance(cls, batch=None):
    """An instance with a distinct float array in every field (the pytree
    contract does not look at field types)."""
    shape = (3,) if batch is None else (batch, 3)
    vals = {f.name: jnp.full(shape, float(i + 1), jnp.float32)
            for i, f in enumerate(dataclasses.fields(cls))}
    return cls(**vals)


@pytest.mark.parametrize("module,name", CLASSES,
                         ids=[n for _, n in CLASSES])
def test_pytree_class_jit_vmap_tree_map_replace(module, name):
    cls = getattr(importlib.import_module(module), name)
    obj = _instance(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    assert len(jax.tree.leaves(obj)) == len(names)

    doubled = jax.jit(lambda o: jax.tree.map(lambda a: 2 * a, o))(obj)
    assert type(doubled) is cls
    for i, n in enumerate(names):
        np.testing.assert_array_equal(getattr(doubled, n), 2.0 * (i + 1))

    batched = _instance(cls, batch=4)
    summed = jax.vmap(lambda o: jax.tree.map(jnp.sum, o))(batched)
    assert type(summed) is cls
    assert getattr(summed, names[0]).shape == (4,)

    new = obj.replace(**{names[-1]: jnp.zeros(5)})
    assert getattr(new, names[-1]).shape == (5,)
    assert getattr(obj, names[-1]).shape == (3,)        # original untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, names[0], None)


def test_pytree_none_and_default_fields():
    @pytree.dataclass
    class Carry:
        a: jnp.ndarray
        b: jnp.ndarray = None
        c: float = 0.0

    obj = Carry(jnp.ones(2))
    assert len(jax.tree.leaves(obj)) == 2               # None has no leaf
    out = jax.jit(lambda o: o.replace(c=o.c + o.a.sum()))(obj)
    assert out.b is None and float(out.c) == 2.0
    flat, treedef = jax.tree_util.tree_flatten_with_path(obj)
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [".a", ".c"]
    rebuilt = jax.tree.unflatten(treedef, [x for _, x in flat])
    assert type(rebuilt) is Carry and rebuilt.b is None
