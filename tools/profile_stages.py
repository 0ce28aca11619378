"""Stage-level timing of the SLAM step on the current backend.

Times each pipeline stage jitted+vmapped separately over the same batch, so
the hot spot is attributable (predict / linearize / IC / RANSAC / update /
mapman / init). Runs on the default backend (the GPU where one is
present) or CPU.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from ekf_slam_tpu.config import EngineConfig, MapConfig, SimConfig
from ekf_slam_tpu.filter import (association, ekf, engine, mapman,
                                 measurement, ransac)
from ekf_slam_tpu.filter.state import init_state
from ekf_slam_tpu.sim import simulate

B = 512
CAP = 100


def timeit(name, fn, *args, reps=5):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:28s} {dt*1e3:9.2f} ms  ({B/dt:9.0f} inst/s)")
    return out


def main():
    cfg = EngineConfig(
        map=MapConfig(capacity=CAP, min_features_in_image=25,
                      max_new_per_step=25),
        sim=SimConfig(num_landmarks=128))
    scn, xs, obs = simulate(jax.random.key(0), cfg, 2)
    obs0 = jax.tree.map(lambda a: a[0], obs)
    obs1 = jax.tree.map(lambda a: a[1], obs)
    st = engine.bootstrap(init_state(cfg), obs0, cfg)
    stb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), st)
    keys = jax.random.split(jax.random.key(1), B)

    f = cfg.filter

    full = jax.jit(jax.vmap(lambda s, k: engine.step(s, obs1, k, cfg)[0]))
    timeit("FULL step", full, stb, keys)

    M = cfg.map.max_update_obs
    z0, zv0 = jax.vmap(engine.gather_measurements)(stb, jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), obs1))
    cmp_upd = jax.jit(jax.vmap(
        lambda s, z_, m_: engine._masked_update(
            s.x, s.P,
            *measurement.predict_and_linearize(s.x, s.P, s, cfg)[2:4],
            z_, measurement.predict_and_linearize(s.x, s.P, s, cfg)[0],
            m_, cfg)))
    timeit(f"compact update (M={M})", cmp_upd, stb, z0, zv0)

    predict = jax.jit(jax.vmap(lambda s: ekf.predict(s.x, s.P, f)))
    xP = timeit("predict", predict, stb)

    lin = jax.jit(jax.vmap(
        lambda x, P, s: measurement.predict_and_linearize(x, P, s, cfg),
        in_axes=(0, 0, 0)))
    hvis = timeit("linearize(h,H,S)", lin, xP[0], xP[1], stb)
    h, visible, H_xv, H_y, S = hvis

    dense = jax.jit(jax.vmap(measurement.dense_H))
    Hd = timeit("dense_H", dense, H_xv, H_y, visible)

    z, zv = jax.vmap(engine.gather_measurements)(stb, jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), obs1))
    ic = jax.jit(jax.vmap(
        lambda z_, zv_, h_, v_, S_: association.individually_compatible(
            z_, zv_, h_, v_, S_, cfg)))(z, zv, h, visible, S)

    rs = jax.jit(jax.vmap(
        lambda x, P, z_, h_, hx_, hy_, S_, ic_, c_, k_: ransac.run(
            x, P, z_, h_, hx_, hy_, S_, ic_, c_, k_, cfg)))
    li = timeit("ransac(64 hyp)", rs, xP[0], xP[1], z, h, H_xv, H_y, S, ic,
                stb.cartesian, keys)[0]

    upd = jax.jit(jax.vmap(
        lambda x, P, Hd_, z_, h_, m_: ekf.update(
            x, P, Hd_, z_.reshape(-1), h_.reshape(-1),
            jnp.repeat(m_, 2), jnp.ones(2 * CAP, x.dtype))))
    timeit("masked update (2*CAP rows)", upd, xP[0], xP[1], Hd, z, h, li)

    dele = jax.jit(jax.vmap(lambda s: mapman.delete_features(s, cfg).x))
    timeit("delete_features", dele, stb)
    conv = jax.jit(jax.vmap(lambda s: mapman.convert_to_cartesian(s, cfg).x))
    timeit("convert_to_cartesian", conv, stb)

    init = jax.jit(jax.vmap(
        lambda s, o: engine.initialize_features(s, o, jnp.asarray(30), cfg).x,
        in_axes=(0, None)))
    timeit("initialize_features", init, stb, obs1)


if __name__ == "__main__":
    main()
