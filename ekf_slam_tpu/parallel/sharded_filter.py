"""Covariance-sharded (tensor-parallel) EKF-SLAM step over a device mesh.

Why: the joint covariance is the filter's memory wall. P is (D, D) with
D = 13 + 6*CAP, so capacity scales HBM quadratically — CAP = 4000 is a
~2.3 GB float32 P per filter instance, and a batch of them stops fitting
one chip long before that. The reference never hits this wall because it
never exceeds ~100 features (and has no parallelism beyond data-parallel
MirroredStrategy — SURVEY.md §2.8); the answer here is to shard P's
ROW axis over the mesh's 'model' axis so per-device covariance memory is
D*D/k and capacity scales with the mesh.

Design — the "annotate the boundary, let XLA partition" recipe:
only the jit in/out shardings are pinned; XLA's SPMD partitioner places
the collectives. Row-sharding P makes every heavy term local:

* ``P @ Hᵀ`` (the update's one full-P read) — row-block local → (D, M)
  shards; the partitioner all-gathers the RESULT, an O(D*M) tensor.
* ``S = H (P Hᵀ) + R`` — M×M, tiny, replicated after the gather.
* the folded-tail correction ``P + Ā B̄ᵀ`` (filter/ekf.py) — Ā, B̄ are
  (D, 2M+8) tall-skinny factors: one O(D*M) all-gather of B̄, then each
  shard computes and adds its own row block. The D×D write stays local.

Three single-device-optimal lowering forms fight the sharding and are
swapped at TRACE time for bit-identical TP-shaped twins (the with-blocks
in `make_sharded_step`; each override's rationale lives at its
definition): the flat slot-diag gather (measurement.sdiag_override →
"dotsel"), the predict stripe DUS (ekf.stripes_override → "predsel":
GSPMD cannot partition a sub-shard DUS on an unevenly tiled dim and
falls back to a full-P all-gather), and the conversion's slot-axis
map-block contraction (mapman.mgrows_override → "rowsel"). A sharding
constraint is also pinned on every freshly materialized P
(ekf.p_annotate): without it the propagation pass sees the many small
row-slice consumers and votes P replicated.

Verified on the compiled HLO (tests/test_sharded_filter.py asserts it):
every collective over the mesh is factor-class — O(D * max(2M+8,
12*max_new, NHYP)) — the covariance itself never crosses the interconnect.

Boundary padding: D is ODD (13 + 6*CAP), and jax requires boundary dims
to divide evenly over their mesh axis, so the sharded state carries
x:(Dp,), P:(Dp, Dp) with Dp = ceil(D/k)*k, zero-padded. The step slices
back to the exact D inside jit (the partitioner handles odd interior
shapes itself) and re-pads the output with ``jnp.pad`` — NOT with a
zeros.at[].set, which materializes a full-P all-gather (measured on the
toy HLO; lax.pad stays shard-local).
"""

from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ekf_slam_tpu.config import CAM_DIM, EngineConfig
from ekf_slam_tpu.filter.state import FilterState


def padded_dim(cfg: EngineConfig, n_model: int) -> tuple[int, int]:
    """(D, Dp): the exact state dim and its model-axis-divisible pad."""
    D = CAM_DIM + 6 * cfg.map.capacity
    Dp = -(-D // n_model) * n_model
    return D, Dp


def pad_state(state: FilterState, Dp: int) -> FilterState:
    """Zero-pad x -> (..., Dp) and P -> (..., Dp, Dp). Pad rows/cols of P
    are zero and stay zero through the step: zero P rows have zero gain
    rows, and predict/manage only write inside the exact-D block."""
    d = state.x.shape[-1]
    if d == Dp:
        return state
    ext = Dp - d
    lead = [(0, 0)] * (state.x.ndim - 1)
    return state.replace(
        x=jnp.pad(state.x, lead + [(0, ext)]),
        P=jnp.pad(state.P, lead + [(0, ext), (0, ext)]))


def unpad_state(state: FilterState, D: int) -> FilterState:
    return state.replace(x=state.x[..., :D], P=state.P[..., :D, :D])


def state_shardings(mesh: Mesh, data_axis: str = "data",
                    model_axis: str = "model") -> FilterState:
    """FilterState-of-NamedShardings for a batched padded state: batch over
    `data_axis`, P's row axis over `model_axis`, everything else
    batch-sharded only."""
    def ns(*spec):
        return NamedSharding(mesh, P(data_axis, *spec))
    return FilterState(
        x=ns(None), P=ns(model_axis, None), active=ns(None),
        cartesian=ns(None), times_predicted=ns(None),
        times_measured=ns(None), landmark_id=ns(None))


def shard_state_batch(state_b: FilterState, mesh: Mesh,
                      cfg: EngineConfig, data_axis: str = "data",
                      model_axis: str = "model") -> FilterState:
    """Pad a batched FilterState to the mesh's divisible dim and place it
    with P row-sharded over `model_axis`, batch over `data_axis`."""
    _, Dp = padded_dim(cfg, mesh.shape[model_axis])
    return jax.device_put(pad_state(state_b, Dp),
                          state_shardings(mesh, data_axis, model_axis))


def make_sharded_step(cfg: EngineConfig, mesh: Mesh,
                      data_axis: str = "data", model_axis: str = "model"):
    """Jitted batched SLAM frame with the covariance tensor-parallel over
    `model_axis` and the batch data-parallel over `data_axis`.

    Returns ``step(states_padded, obs, keys) -> (states_padded, infos)``
    where `states_padded` is a `shard_state_batch`-placed batch and `obs`
    a single replicated frame. Use `unpad_state(out, cfg.map.state_dim)`
    to read results.
    """
    from ekf_slam_tpu.filter import engine, ekf, mapman, measurement

    D, Dp = padded_dim(cfg, mesh.shape[model_axis])
    st_sh = state_shardings(mesh, data_axis, model_axis)
    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(data_axis))

    @functools.partial(
        jax.jit,
        in_shardings=(st_sh, repl, batch_sh),
        out_shardings=(st_sh, batch_sh))
    def step_b(states_p: FilterState, obs, keys):
        # Trace-time form overrides: the single-device-measured-best
        # lowering forms all fight a row-sharded P (flat P.reshape(-1)
        # merges the sharded dim; the predict row-stripe DUS at offset 13
        # partially covers every shard; the conversion's slot-axis
        # contraction reads the whole map block cross-mesh). Their
        # bit-identical TP-shaped twins partition locally — each knob's
        # rationale lives at its definition.
        p_sh = NamedSharding(mesh, P(model_axis, None))
        with ekf.stripes_override("predsel"), \
                measurement.sdiag_override("dotsel"), \
                mapman.mgrows_override("rowsel"), \
                ekf.p_annotate(
                    lambda Pm: jax.lax.with_sharding_constraint(Pm, p_sh)):
            states = unpad_state(states_p, D)
            new, infos = jax.vmap(
                lambda s, k: engine.step(s, obs, k, cfg))(states, keys)
            return pad_state(new, Dp), infos

    return step_b


_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_OPCODE_RE = re.compile(r"\s([a-z][\w-]*)\(")
_SHAPE_RE = re.compile(r"\b[a-z]+\d*\[([\d,]*)\]")


def collective_inventory(compiled_text: str) -> list[str]:
    """The collective ops of a compiled HLO, one line each — used to
    assert nothing D×D-sized crosses the mesh. Covers the synchronous
    forms and the async `-start` forms (the `-done` halves repeat them);
    tuple-typed results included."""
    out = []
    for line in compiled_text.splitlines():
        ls = line.strip()
        if not (ls.startswith("%") or ls.startswith("ROOT")):
            continue
        parts = ls.split(" = ", 1)
        m = _OPCODE_RE.search(" " + parts[1]) if len(parts) == 2 else None
        if m is None:
            continue
        opc = m.group(1)
        if opc.endswith("-done"):
            continue
        if any(opc == c or opc == c + "-start" for c in _COLLECTIVES):
            out.append(ls)
    return out


def collective_payload(line: str) -> int:
    """Largest element count among the shapes of a collective's result
    type (a tuple-typed async start carries operand and result)."""
    rhs = line.split(" = ", 1)[1]
    type_part = rhs[:_OPCODE_RE.search(" " + rhs).start()]
    best = 0
    for m in _SHAPE_RE.finditer(type_part):
        n = 1
        for d in m.group(1).split(","):
            if d:
                n *= int(d)
        best = max(best, n)
    return best
