"""Riccati recursion for affine LQ optimal-control subproblems.

This is the JAX replacement for the factorization engine inside HPIPM
(selected by the reference as its QP backend, /root/reference/gpmpc/mpc.py:115):
every interior-point iteration of the OCP-QP reduces to one equality-constrained
affine LQR solve, performed here as a backward `lax.scan` over stages followed by a
forward rollout. All per-stage blocks are tiny (nx=12, nu=4); this is the plain
reference path, batched with `vmap`; the throughput path is the scenario-blocked
QP kernel in ops/pallas_ocp.py (≙ BLASFEO's role, SURVEY.md §2.2).

Solves:
    min_{dx, du}  sum_k 1/2 dx_k'Qxx_k dx_k + qx_k'dx_k
                        + 1/2 du_k'Ruu_k du_k + ru_k'du_k
    s.t.          dx_{k+1} = A_k dx_k + B_k du_k + r_k,   dx_0 = dx0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LqProblem(NamedTuple):
    """Stage-wise affine LQ data. Shapes: T stages, state nx, input nu.

    A:   (T, nx, nx)   B: (T, nx, nu)   r: (T, nx)
    Qxx: (T+1, nx, nx) qx: (T+1, nx)
    Ruu: (T, nu, nu)   ru: (T, nu)
    """

    A: jax.Array
    B: jax.Array
    r: jax.Array
    Qxx: jax.Array
    qx: jax.Array
    Ruu: jax.Array
    ru: jax.Array


class LqSolution(NamedTuple):
    dx: jax.Array  # (T+1, nx)
    du: jax.Array  # (T, nu)
    K: jax.Array  # (T, nu, nx) feedback gains
    kff: jax.Array  # (T, nu) feedforward terms


def _backward_step(carry, inputs):
    P_next, p_next = carry
    A, B, r, Qxx, qx, Ruu, ru = inputs

    # Full-f32 matmuls, not a reduced-precision default (TF32 on a GPU, bf16
    # elsewhere): the interior-point barrier pushes entries of P/Qxx to
    # ~1e6-1e8 near convergence, and a short mantissa is enough to lose Guu's
    # positive-definiteness (NaN Cholesky). The blocks are 12x12.
    prec = jax.lax.Precision.HIGHEST

    # Q-function blocks around the affine dynamics dx' = A dx + B du + r.
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)
    Fr_p = mm(P_next, r) + p_next  # (nx,)
    AtP = mm(A.T, P_next)
    BtP = mm(B.T, P_next)
    Gxx = Qxx + mm(AtP, A)
    Guu = Ruu + mm(BtP, B)
    Gxu = mm(AtP, B)
    gx = qx + mm(A.T, Fr_p)
    gu = ru + mm(B.T, Fr_p)

    # du* = K dx + kff via Cholesky of the (nu, nu) block.
    chol = jnp.linalg.cholesky(Guu)
    K = -jax.scipy.linalg.cho_solve((chol, True), Gxu.T)
    kff = -jax.scipy.linalg.cho_solve((chol, True), gu)

    P = Gxx + mm(Gxu, K)
    P = 0.5 * (P + P.T)
    p = gx + mm(Gxu, kff)
    return (P, p), (K, kff)


def riccati_solve(lq: LqProblem, dx0: jax.Array) -> LqSolution:
    """Backward Riccati sweep + forward rollout, both as `lax.scan`."""
    P_T = lq.Qxx[-1]
    p_T = lq.qx[-1]
    (_, _), (K, kff) = jax.lax.scan(
        _backward_step,
        (P_T, p_T),
        (lq.A, lq.B, lq.r, lq.Qxx[:-1], lq.qx[:-1], lq.Ruu, lq.ru),
        reverse=True,
    )

    def _forward_step(dx, inputs):
        A, B, r, K_k, kff_k = inputs
        mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        du = mm(K_k, dx) + kff_k
        dx_next = mm(A, dx) + mm(B, du) + r
        return dx_next, (dx, du)

    dx_T, (dx_path, du) = jax.lax.scan(_forward_step, dx0, (lq.A, lq.B, lq.r, K, kff))
    dx = jnp.concatenate([dx_path, dx_T[None]], axis=0)
    return LqSolution(dx=dx, du=du, K=K, kff=kff)
