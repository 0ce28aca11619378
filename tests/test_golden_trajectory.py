"""Multi-step golden-trajectory fidelity: padded engine vs the float64
dynamic-shape oracle (BASELINE.json: trajectory RMSE <= 1e-6).

The oracle mirrors the reference equations verbatim (explicit inv(S),
physically-sized state); the engine runs the padded masked path with
Cholesky solves. Over a 20-frame predict+update sequence on a known
cartesian map with fixed noisy measurements, the camera trajectories must
agree to 1e-6 — proving masking, padding, and the Cholesky gain are
algebraically faithful to the reference math.

The engine side is vmapped over a batch of 2 identical instances: XLA:CPU
lowers SIZE-1 transcendentals through a ~3e-8 approximation even in float64
while batched ones take the accurate path (see ops/quaternion.py PRECISION
NOTE); the batch axis is also the engine's real operating mode.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ekf_slam_tpu.config import (CAM_DIM, EngineConfig, FilterConfig,
                                 MapConfig)
from ekf_slam_tpu.filter import ekf, measurement
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.oracle import oracle

N_LM = 8
T = 20
SIGMA_Z = 1.0


def setup():
    rng = np.random.default_rng(0)
    landmarks = np.stack([
        rng.uniform(-1.5, 1.5, N_LM),
        rng.uniform(-1.0, 1.0, N_LM),
        rng.uniform(3.0, 6.0, N_LM)], axis=1)
    cfg = EngineConfig(map=MapConfig(capacity=N_LM), dtype="float64")
    return cfg, landmarks, rng


def oracle_run(cfg, landmarks, z_seq, valid_seq):
    f = cfg.filter
    cam = cfg.camera
    x, P = oracle.initialize_x_and_p(f)
    x = np.concatenate([x, landmarks.reshape(-1)])
    D = 13 + 3 * N_LM
    P_full = np.zeros((D, D))
    P_full[:13, :13] = P
    P_full[13:, 13:] = np.eye(3 * N_LM) * 1e-4
    traj = []
    for t in range(T):
        x, P_full = oracle.predict(x, P_full, f)
        rows, zs, hs = [], [], []
        R_wc = oracle.q2r(x[3:7])
        for i in range(N_LM):
            if not valid_seq[t, i]:
                continue
            y = x[13 + 3 * i: 16 + 3 * i]
            h, vis = oracle.hi_cartesian(y, x[0:3], R_wc, cam)
            if not vis:
                continue
            H_xv, H_y = oracle.Hi_cartesian(x[0:13], y, h, cam)
            Hrow = np.zeros((2, D))
            Hrow[:, 0:13] = H_xv
            Hrow[:, 13 + 3 * i: 16 + 3 * i] = H_y
            rows.append(Hrow)
            zs.append(z_seq[t, i])
            hs.append(h)
        H = np.concatenate(rows, axis=0)
        z = np.concatenate(zs)
        h = np.concatenate(hs)
        R = np.eye(len(z)) * SIGMA_Z**2
        x, P_full = oracle.ekf_update(x, P_full, H, R, z, h)
        traj.append(x[:13].copy())
    return np.array(traj)


def engine_run(cfg, landmarks, z_seq, valid_seq):
    st = init_state(cfg)
    cap = cfg.map.capacity
    slots = jnp.zeros((cap, 6), jnp.float64).at[:, 0:3].set(landmarks)
    x = st.x.at[CAM_DIM:].set(slots.reshape(-1))
    d_idx = (CAM_DIM + 6 * jnp.arange(cap)[:, None]
             + jnp.arange(3)[None]).reshape(-1)
    P = st.P.at[d_idx, d_idx].set(1e-4)
    st = st.replace(x=x, P=P,
                    active=jnp.ones(cap, bool),
                    cartesian=jnp.ones(cap, bool),
                    landmark_id=jnp.arange(cap))
    f = cfg.filter

    def one_step(x, P, z, zv):
        x, P = ekf.predict(x, P, f)
        h, visible, hc = measurement.predict_measurements(
            x, st.active, st.cartesian, cfg)
        H_xv, H_y = measurement.jacobians(x, h, hc, st.cartesian, cfg.camera)
        use = visible & zv
        H = measurement.dense_H(H_xv, H_y, use)
        x, P = ekf.update(
            x, P, H, z.reshape(-1), h.reshape(-1), jnp.repeat(use, 2),
            jnp.full(2 * cap, SIGMA_Z**2, jnp.float64))
        return x, P

    # batch of 2 identical instances (accurate transcendental path).
    def scan_fn(carry, inp):
        x, P = carry
        z, zv = inp
        x, P = jax.vmap(one_step)(x, P, z, zv)
        return (x, P), x[:, :13]

    B = 2
    xb = jnp.broadcast_to(st.x, (B,) + st.x.shape)
    Pb = jnp.broadcast_to(st.P, (B,) + st.P.shape)
    z_b = jnp.broadcast_to(jnp.asarray(z_seq), (B,) + z_seq.shape)
    zv_b = jnp.broadcast_to(jnp.asarray(valid_seq), (B,) + valid_seq.shape)
    (_, _), traj = jax.lax.scan(
        scan_fn, (xb, Pb),
        (jnp.swapaxes(z_b, 0, 1), jnp.swapaxes(zv_b, 0, 1)))
    return np.asarray(traj[:, 0])


def test_golden_trajectory_rmse():
    cfg, landmarks, rng = setup()
    cam = cfg.camera
    f = cfg.filter
    # Generate measurements from the ORACLE's own predicted trajectory with
    # fixed noise so both paths consume identical inputs.
    x, _ = oracle.initialize_x_and_p(f)
    x[7:10] = [0.002, 0.0, 0.004]   # gentle drift so poses change
    z_seq = np.zeros((T, N_LM, 2))
    valid = np.zeros((T, N_LM), bool)
    x_t = x.copy()
    for t in range(T):
        x_t = oracle.fv(x_t, f.delta_t, f)
        R_wc = oracle.q2r(x_t[3:7] / np.linalg.norm(x_t[3:7]))
        for i in range(N_LM):
            h, vis = oracle.hi_cartesian(landmarks[i], x_t[0:3], R_wc, cam)
            z_seq[t, i] = h + rng.normal(0, 0.3, 2) if vis else 0.0
            valid[t, i] = vis
    assert valid.sum() > T * N_LM * 0.9

    ref = oracle_run(cfg, landmarks, z_seq, valid)
    got = engine_run(cfg, landmarks, z_seq, jnp.asarray(valid))

    rmse_pos = np.sqrt(np.mean((ref[:, 0:3] - got[:, 0:3]) ** 2))
    rmse_all = np.sqrt(np.mean((ref - got) ** 2))
    assert rmse_pos < 1e-6, rmse_pos
    assert rmse_all < 1e-6, rmse_all
