"""FULL-pipeline golden trajectory: padded masked engine vs the
sequential dynamic-shape float64 oracle through ALL EIGHT stages —
map management (delete + convert), predict, association, 1-point RANSAC,
LI update, HI rescue/update, counters and inverse-depth feature init
(mono_slam.m:50-82 order). Replaces the round-1 cartesian-only golden
claim.

Both sides consume identical observations and identical RANSAC draws (the
oracle calls the engine's sample_ic_indices on its own ic mask with the
same per-frame key; the test asserts the masks agree every frame, so the
draws agree). RMSE <= 1e-6 on the camera trajectory AND on every live
feature estimate."""

import jax
import numpy as np
import pytest

from ekf_slam_tpu.config import CAM_DIM
from ekf_slam_tpu.filter import engine
from ekf_slam_tpu.oracle.pipeline import compare_with_oracle, golden_config
from ekf_slam_tpu.sim import simulate

T = 24


@pytest.mark.slow
def test_full_pipeline_golden():
    cfg = golden_config()
    scn, xs, obs = simulate(jax.random.key(4), cfg, T)
    step = jax.jit(engine.step, static_argnames="cfg")
    res = compare_with_oracle(
        cfg, obs, lambda s, o, k: step(s, o, k, cfg),
        key_fn=lambda t: jax.random.key(300 + t), force_convert_at=T // 2)

    # sanity: bootstrap states agree
    assert res["bootstrap_rmse"] < 1e-9
    # discrete-decision parity each frame (IC / LI / HI counts + support)
    assert all(res["counts_equal"]), res["counts_equal"]
    # Coverage: all mutation stages must actually have fired.
    st, orc = res["state"], res["oracle"]
    assert res["converted"] and any(r.kind == "c" for r in orc.recs), \
        "conversion never exercised"
    assert int(np.asarray(st.cartesian).sum()) >= 1
    slots = np.asarray(st.x[CAM_DIM:]).reshape(-1, 6)
    for s, i in orc.by_slot().items():
        if orc.recs[i].kind == "c":
            np.testing.assert_allclose(slots[s][3:], 0.0, atol=1e-12)
    assert res["rmse"][-1] < 1e-6, res["rmse"][-1]
