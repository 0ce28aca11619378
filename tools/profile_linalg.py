"""Micro-benchmarks of the update's linear-algebra primitives on the
default backend (the GPU where one is present)."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

B = 512
D = 613
M = 128


def timeit(name, fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    print(f"{name:34s} {(time.perf_counter()-t0)/reps*1e3:9.2f} ms")


def main():
    key = jax.random.key(0)
    A = jax.random.normal(key, (B, M, M)) * 0.1
    S = A @ jnp.swapaxes(A, 1, 2) + jnp.eye(M)
    P = jax.random.normal(key, (B, D, D)) * 0.01
    H = jax.random.normal(key, (B, M, D)) * 0.1

    timeit("cholesky (B,M,M)", jax.jit(jax.lax.linalg.cholesky), S)

    chol = jax.lax.linalg.cholesky(S)
    eye = jnp.eye(M)
    eye_b = jnp.broadcast_to(eye, (B, M, M))
    tri = jax.jit(lambda L: jax.scipy.linalg.solve_triangular(
        L, eye_b, lower=True))
    timeit("tri-inverse (B,M,M)", tri, chol)

    timeit("PHt (B,D,D)@(B,D,M)", jax.jit(
        lambda p, h: p @ jnp.swapaxes(h, 1, 2)), P, H)

    Kt = jax.random.normal(key, (B, D, M))
    timeit("downdate K@PHt.T", jax.jit(
        lambda k, p: p - k @ jnp.swapaxes(k, 1, 2) @ jnp.eye(M) @ ...
        if False else p - (k @ jnp.swapaxes(k, 1, 2))), Kt, P)

    timeit("symmetrize", jax.jit(lambda p: 0.5 * (p + jnp.swapaxes(p, 1, 2))),
           P)

    timeit("full-P where pass", jax.jit(
        lambda p: jnp.where(p > 0, p, 0.5 * p)), P)

    # LU alternative
    timeit("lu solve (B,M,M) eye", jax.jit(
        lambda s: jnp.linalg.solve(s, jnp.eye(M))), S)

    # smaller M
    for m2 in (64, 96):
        S2 = S[:, :m2, :m2]
        timeit(f"cholesky M={m2}", jax.jit(jax.lax.linalg.cholesky), S2)
        timeit(f"tri-inverse M={m2}", jax.jit(
            lambda L, m2=m2: jax.scipy.linalg.solve_triangular(
                L[:, :m2, :m2],
                jnp.broadcast_to(jnp.eye(m2), (B, m2, m2)),
                lower=True)), chol)


if __name__ == "__main__":
    main()
