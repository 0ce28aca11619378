"""chip_smoke.py and bench.py on the CPU: both refuse to report without a
GPU, every chip_smoke phase body is rehearsed at a tiny size (the
multichip phase on 4 of the virtual CPU devices), and the helpers they
share (compile cache, host-side ATE, device-free imports) behave."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# bench.py sets its EKF_* defaults in os.environ when imported; keep them
# out of the environment the other tests and subprocesses see.
_env = dict(os.environ)
import bench  # noqa: E402
import chip_smoke  # noqa: E402
os.environ.clear()
os.environ.update(_env)

TINY_SIM = dict(cap=12, m=0, nhyp=16, num_landmarks=24)


def _run(args, env=None, cwd=REPO, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _has_ok_line(stdout):
    return any('"ok": true' in ln for ln in stdout.splitlines())


def test_chip_smoke_refuses_cpu_backend():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)
    assert "refusing" in r.stderr


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)


def test_bench_refuses_cpu_backend():
    r = _run(["bench.py"], env={"BENCH_BATCH": "2", "BENCH_FRAMES": "2"})
    assert r.returncode != 0
    assert "refusing to report" in r.stderr
    assert '"metric"' not in r.stdout


def test_phase_sim_tiny():
    res, fails = chip_smoke.phase_sim(batch=4, frames=4, **TINY_SIM)
    assert fails == [], fails
    assert res["finite_traj"] and res["finite_P"]
    assert res["steps_per_sec"] > 0 and res["compile_s"] > 0
    assert res["memory"]["temp_size_in_bytes"] > 0
    assert res["tracking_err"] < 0.2 and res["ate_p95"] < 0.15


def test_phase_pixels_tiny():
    res, fails = chip_smoke.phase_pixels(batch=4, frames=3, chains=2,
                                         cap=12)
    assert fails == [], fails
    assert res["chains"] == 2 and res["tracking_err"] < 0.5


def test_phase_oracle_golden_tiny():
    # the test process runs with x64 enabled (conftest), as the chip
    # phase's child does
    res, fails = chip_smoke.phase_oracle_golden(frames=12)
    assert fails == [], fails
    assert res["converted"] and res["counts_equal_frames"] == 11
    assert res["bootstrap_rmse"] < 1e-9


def test_phase_oracle_f32_tiny():
    res, fails = chip_smoke.phase_oracle_f32(frames=4, **TINY_SIM)
    assert fails == [], fails
    assert len(res["rmse"]) == 4 and res["max_rmse"] <= res["bound"]


def test_phase_multichip_tiny():
    assert jax.device_count() >= 4
    res, fails = chip_smoke.phase_multichip(batch=8, frames=3, tp_frames=2,
                                            cap=24, n_dev=4)
    assert fails == [], fails
    assert res["fast_traj_shards"] == [(2, 3, 13)]
    assert res["fast_instances_over_tol"] == 0
    assert res["tp_Dp"] % 4 == 0 and res["tp_collectives"] > 0
    assert res["tp_largest_collective_elems"] <= res["tp_factor_limit_elems"]


def test_gate_failures_name_each_gate():
    good = {"finite_traj": True, "finite_P": True, "max_obs": 10,
            "m_cap": 24, "tracking_err": 0.1, "ate_p95": 0.08}
    assert bench.sim_gate_failures(good) == []
    bad = dict(good, finite_P=False, max_obs=25, tracking_err=0.3,
               ate_p95=float("nan"))
    fails = bench.sim_gate_failures(bad)
    assert len(fails) == 4
    pix = {"finite_traj": True, "finite_P": True, "tracking_err": 0.7,
           "search_r_needed": 13.0, "search_radius": 12}
    assert len(bench.pixels_gate_failures(pix)) == 1
    assert len(bench.pixels_gate_failures(pix, radius_gate=True)) == 2


def test_ate_rmse_np_matches_jax_reference():
    from ekf_slam_tpu.utils import trajectory
    k1, k2 = jax.random.split(jax.random.key(0))
    gt = jnp.cumsum(jax.random.normal(k1, (16, 3)), axis=0)
    est = gt[None] + 0.1 * jax.random.normal(k2, (5, 16, 3))
    ref = jax.vmap(lambda e: trajectory.ate_rmse(e, gt))(est)
    np.testing.assert_allclose(bench.ate_rmse_np(est, gt), np.asarray(ref),
                               rtol=1e-6, atol=1e-9)


def test_compile_cache_default_dir(monkeypatch):
    from ekf_slam_tpu.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_follows_env(tmp_path):
    code = ("from ekf_slam_tpu.utils.compile_cache import "
            "enable_compile_cache; import jax; "
            "print(enable_compile_cache(), "
            "jax.config.jax_compilation_cache_dir)")
    r = _run(["-c", code],
             env={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_main_path_imports_without_flax():
    code = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax"):
            raise ImportError(f"{name} blocked")
sys.meta_path.insert(0, _Block())
import ekf_slam_tpu.filter.engine, ekf_slam_tpu.vision.frontend
import ekf_slam_tpu.sim, ekf_slam_tpu.parallel, ekf_slam_tpu.ops
import ekf_slam_tpu.utils, ekf_slam_tpu.io, ekf_slam_tpu.oracle.pipeline
import ekf_slam_tpu.models.loopclosure
import bench, chip_smoke
assert not any(m.split(".")[0] in ("flax", "orbax") for m in sys.modules)
print("ok")
"""
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.gpu
def test_chip_smoke_oracle_phases_on_gpu(gpu):
    """On the card: the golden float64 comparison (x64 is on in the test
    process) and the float32 parity comparison at a tiny width."""
    res, fails = chip_smoke.phase_oracle_golden(frames=12)
    assert fails == [], fails
    res, fails = chip_smoke.phase_oracle_f32(frames=4, **TINY_SIM)
    assert fails == [], fails
