"""Miniature KITTI-format sequence fixture, executed end to end FROM DISK.

The reference's online loop runner consumes an image
directory + a KITTI VO pose file (close_kitti_loops.py:78-106, takeImage.m
:1-4); until now this framework's analog ran only on in-memory arrays.
Here a rendered miniature sequence (PGM frames + 12-float pose rows) is
written to disk, then:

* `examples/close_loops.py` — the close_kitti_loops analog — runs as a
  SUBPROCESS against those files (native C++ loader -> CALC2 embed ->
  ring-DB retrieval -> geometric verify -> temporal filter) and must
  emit the reference's three artifacts (kitti_traj/loops/q_times);
* `examples/run_slam.py --mode sequence` tracks the same frames from
  disk through the full pixels filter pipeline.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "examples"))

FRAMES = 20


@pytest.fixture(scope="module")
def kitti_seq(tmp_path_factory):
    """Render a 400-degree pan (genuine revisit in the last frames) and
    write it in KITTI layout: %06d.pgm frames + poses.txt."""
    from run_loop_closure import make_surround_scene, pan_trajectory

    from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
    from ekf_slam_tpu.io.poses import save_trajectory_kitti
    from ekf_slam_tpu.io.sequence import write_pgm
    from ekf_slam_tpu.vision import frontend

    d = tmp_path_factory.mktemp("kitti_mini")
    cfg = EngineConfig(
        map=MapConfig(capacity=48, min_features_in_image=16,
                      max_new_per_step=16),
        sim=SimConfig(num_landmarks=64, depth_min=2.0, depth_max=6.0))
    scn = make_surround_scene(jax.random.key(0), cfg, n_anchors=12)
    xs = pan_trajectory(cfg, FRAMES, total_deg=400.0)
    render = jax.jit(frontend.render_scene_image, static_argnames="cfg")
    for t in range(FRAMES):
        img = np.asarray(render(scn, xs[t], cfg))
        write_pgm(str(d / f"{t:06d}.pgm"),
                  (img * 255).astype(np.uint8))
    save_trajectory_kitti(str(d / "poses.txt"), np.asarray(xs[:, :7]))
    return d


def _run(cmd):
    return subprocess.run([sys.executable] + cmd, cwd=REPO,
                          capture_output=True, text=True, timeout=900)


def test_close_loops_runs_from_disk(kitti_seq, tmp_path):
    out = tmp_path / "loops_out"
    r = _run(["examples/close_loops.py",
              "--poses", str(kitti_seq / "poses.txt"),
              "--pattern", str(kitti_seq / "%06d.pgm"),
              "--frames", str(FRAMES), "--out", str(out), "--cpu",
              "--plot"])
    assert r.returncode == 0, r.stderr[-3000:]

    # All three close_kitti_loops.py artifacts (:141-158).
    from ekf_slam_tpu.io.poses import load_kitti_poses, poses_to_rq
    traj = load_kitti_poses(str(out / "kitti_traj.txt"))
    assert traj.shape == (FRAMES, 3, 4)
    src = poses_to_rq(load_kitti_poses(str(kitti_seq / "poses.txt")))
    np.testing.assert_allclose(poses_to_rq(traj)[:, :3], src[:, :3],
                               atol=1e-6)
    q = np.loadtxt(out / "kitti_q_times.txt")
    assert q.shape == (FRAMES, 3)
    assert os.path.exists(out / "kitti_loops.txt")
    loops = np.loadtxt(out / "kitti_loops.txt")
    if loops.size:   # rows: i j pose_i(7) pose_j(7)
        loops = np.atleast_2d(loops)
        assert loops.shape[1] == 16
        # declared loops must respect the recency exclusion
        assert (loops[:, 0] - loops[:, 1] >= FRAMES // 4).all()
    # --plot wrote the plot_loops.m analog figure (plot_loops.m:17-27).
    assert os.path.getsize(out / "loops.png") > 0


def test_plot_loops_draws_chords(tmp_path):
    """plot_loops on a synthetic artifact pair with a KNOWN loop: the
    fixture sequence may legitimately declare zero loops, so the chord
    branch (plot_loops.m:22-26) gets its own deterministic input."""
    from ekf_slam_tpu.io.poses import save_trajectory_kitti
    from ekf_slam_tpu.viz import load_loop_artifacts, plot_loops

    T = 12
    traj = np.zeros((T, 7))
    traj[:, 3] = 1.0                       # identity quaternion
    traj[:, 0] = np.cos(np.linspace(0, 2 * np.pi, T))
    traj[:, 2] = np.sin(np.linspace(0, 2 * np.pi, T))
    tp = tmp_path / "kitti_traj.txt"
    lp = tmp_path / "kitti_loops.txt"
    save_trajectory_kitti(str(tp), traj)
    with open(lp, "w") as f:
        row = [11, 0] + list(traj[11]) + list(traj[0])
        f.write(" ".join(str(float(v)) for v in row) + "\n")
    n = plot_loops(str(tmp_path / "loops.png"), str(tp), str(lp))
    assert n == 1
    assert os.path.getsize(tmp_path / "loops.png") > 0

    tr, li, lj, ri, rj = load_loop_artifacts(str(tp), str(lp))
    np.testing.assert_allclose(tr, traj[:, 0:3], atol=1e-7)
    assert (li[0], lj[0]) == (11, 0)
    np.testing.assert_allclose(ri[0], traj[11, 0:3], atol=1e-7)

    # Empty loops file (the reference's common case): no chords, no crash.
    lp2 = tmp_path / "empty_loops.txt"
    lp2.write_text("")
    assert plot_loops(str(tmp_path / "loops2.png"), str(tp),
                      str(lp2)) == 0


def test_loops_file_feeds_loop_fusion(tmp_path):
    """The from-disk consumer chain the reference never wrote
    (close_kitti_loops.py:141-150 files constraints and stops): a
    kitti_loops.txt row loaded with io.poses.load_loops drives
    filter/loop_fusion.apply_loop_constraint_pose and pulls the state
    toward the matched frame's stored pose."""
    import jax
    import jax.numpy as jnp

    from ekf_slam_tpu.config import EngineConfig
    from ekf_slam_tpu.filter import loop_fusion
    from ekf_slam_tpu.filter.state import init_state
    from ekf_slam_tpu.io.poses import load_loops

    lp = tmp_path / "kitti_loops.txt"
    pose_i = [0.30, 0.02, -0.10, 1.0, 0.0, 0.0, 0.0]   # drifted estimate
    pose_j = [0.00, 0.00, 0.00, 1.0, 0.0, 0.0, 0.0]    # matched frame
    with open(lp, "w") as f:
        f.write(" ".join(str(float(v))
                         for v in [9, 1] + pose_i + pose_j) + "\n")
    i, j, pi, pj = load_loops(str(lp))
    assert (i[0], j[0]) == (9, 1)

    st = init_state(EngineConfig())
    x = st.x.at[0:3].set(jnp.asarray(pose_i[:3], st.x.dtype))
    # drifted filter: uncertain about its pose (init P is ~0 = certain,
    # which would correctly zero the gain)
    P = st.P.at[0:3, 0:3].set(0.1 * jnp.eye(3, dtype=st.P.dtype))
    sp, sr = loop_fusion.loop_noise_sigmas(jnp.asarray(12))
    x_new, P_new = loop_fusion.apply_loop_constraint_pose(
        x, P, jnp.asarray(pj[0], st.x.dtype), sp, sr,
        jnp.asarray(True))
    assert bool(jnp.all(jnp.isfinite(x_new)))
    assert bool(jnp.all(jnp.isfinite(P_new)))
    # the constraint pulls the position toward pose_j
    d0 = float(jnp.linalg.norm(x[0:3] - jnp.asarray(pj[0, 0:3])))
    d1 = float(jnp.linalg.norm(x_new[0:3] - jnp.asarray(pj[0, 0:3])))
    assert d1 < d0

    empty = tmp_path / "empty16.txt"
    empty.write_text("")
    ei, _ej, _epi, epj = load_loops(str(empty))
    assert ei.size == 0 and epj.shape == (0, 7)


def test_loop_e2e_auto_threshold_calibrates(tmp_path):
    """--sim-threshold 0 (r5): the per-run auto-calibration must set a
    gate ABOVE the sampled impostor band and declare only genuine
    revisits on the short pan (turn = 0.8*T frames). Fast config: sim
    frontend, 1 seed."""
    out = tmp_path / "auto.json"
    r = _run(["examples/run_loop_closure.py", "--frontend", "sim",
              "--traj", "pan", "--frames", "40", "--ensemble", "1",
              "--sim-threshold", "0", "--cpu", "--json", str(out)])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "auto sim_threshold" in r.stdout
    import json as _json
    with open(out) as f:
        s = _json.load(f)
    turn = int(round(40 * 360.0 / 450.0))
    for row in s["rows"]:
        for i, j in row["loops"]:
            assert abs((i - j) - turn) <= 3, \
                f"non-genuine loop {i}->{j} passed the calibrated gate"


def test_run_slam_sequence_mode_from_disk(kitti_seq, tmp_path):
    out = tmp_path / "slam_out"
    r = _run(["examples/run_slam.py", "--mode", "sequence",
              "--pattern", str(kitti_seq / "%06d.pgm"),
              "--start", "0", "--frames", "6",
              "--out", str(out), "--cpu"])
    assert r.returncode == 0, r.stderr[-3000:]
    dat = np.load(out / "trajectory.npz")
    assert dat["trajectory"].shape[0] == 6
    assert np.isfinite(dat["trajectory"]).all()
