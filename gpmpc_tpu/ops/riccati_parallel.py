"""Parallel-in-time Riccati: O(log T)-depth associative-scan LQR.

The sequential Riccati recursion in `riccati.py` has an O(T) dependency chain. For
long horizons (BASELINE.md "2x horizon" config) the backward pass is an associative
operation on conditional-value-function elements, so `jax.lax.associative_scan`
evaluates it in O(log T) depth — the OCP-horizon analogue of ring/context
parallelism for sequence models (SURVEY.md §5 "long-context"). Under `pjit` with
the stage axis sharded over a mesh, XLA turns the combine tree into ICI
collectives, which is the multi-chip long-horizon path.

Representation (Särkkä-style parallel LQT): each element e = (A, b, C, eta, J)
encodes a conditional value function

    V_e(x, z) = 1/2 (z - A x - b)' C^+ (z - A x - b) + 1/2 x' J x - eta' x

for entering state x and exit state z. Composition of e_i (earlier) with e_j
(later) is

    A_ij  = A_j (I + C_i J_j)^-1 A_i
    b_ij  = A_j (I + C_i J_j)^-1 (b_i + C_i eta_j) + b_j
    C_ij  = A_j (I + C_i J_j)^-1 C_i A_j' + C_j
    eta_ij= A_i' (I + J_j C_i)^-1 (eta_j - J_j b_i) + eta_i
    J_ij  = A_i' (I + J_j C_i)^-1 J_j A_i + J_i

The suffix combination e_k x ... x e_T yields the value function
V_k(x) = 1/2 x' J x - eta' x, i.e. P_k = J and p_k = -eta (verified against the
sequential recursion in tests/test_riccati_parallel.py). Stage init for dynamics
x' = A x + B u + r and costs (Qxx, qx), (Ruu, ru):

    A_e = A,  C_e = B Ruu^-1 B',  b_e = r - B Ruu^-1 ru,  J_e = Qxx,  eta_e = -qx

and the terminal element is (0, 0, 0, -qx_T, Qxx_T).

The forward rollout is parallelized the same way: with gains K_k, kff_k computed
pointwise from (P_{k+1}, p_{k+1}), the closed loop x_{k+1} = F_k x_k + f_k is a
composition of affine maps — a second associative scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops.riccati import LqProblem, LqSolution


class _ValueElem(NamedTuple):
    A: jax.Array
    b: jax.Array
    C: jax.Array
    eta: jax.Array
    J: jax.Array


def _combine(ei: _ValueElem, ej: _ValueElem) -> _ValueElem:
    """Compose earlier element ei with later element ej (batched over leading axes)."""
    n = ei.A.shape[-1]
    eye = jnp.eye(n, dtype=ei.A.dtype)
    # (I + C_i J_j)^-1 via LU (small, batched).
    M = eye + ei.C @ ej.J
    Minv_Ai = jnp.linalg.solve(M, ei.A)
    Minv_bCeta = jnp.linalg.solve(M, (ei.b + jnp.einsum("...ij,...j->...i", ei.C, ej.eta))[..., None])[..., 0]
    Minv_Ci = jnp.linalg.solve(M, ei.C)
    # (I + J_j C_i)^-1 = (I + (C_i' J_j')')^-1 ; use its own solve.
    N = eye + ej.J @ ei.C
    Ninv_Jj = jnp.linalg.solve(N, ej.J)
    Ninv_rhs = jnp.linalg.solve(N, (ej.eta - jnp.einsum("...ij,...j->...i", ej.J, ei.b))[..., None])[..., 0]

    AiT = jnp.swapaxes(ei.A, -1, -2)
    AjT = jnp.swapaxes(ej.A, -1, -2)
    return _ValueElem(
        A=ej.A @ Minv_Ai,
        b=jnp.einsum("...ij,...j->...i", ej.A, Minv_bCeta) + ej.b,
        C=ej.A @ Minv_Ci @ AjT + ej.C,
        eta=jnp.einsum("...ij,...j->...i", AiT, Ninv_rhs) + ei.eta,
        J=AiT @ Ninv_Jj @ ei.A + ei.J,
    )


def riccati_solve_parallel(lq: LqProblem, dx0: jax.Array) -> LqSolution:
    """Associative-scan LQR solve; same contract as `riccati.riccati_solve`."""
    # Full-f32 matmuls (not a reduced-precision default): IP barrier weights
    # push P/Qxx entries to ~1e6-1e8 and TF32/bf16 rounding can cost Guu its positive-
    # definiteness (NaN Cholesky) — see riccati.py::_backward_step.
    with jax.default_matmul_precision("highest"):
        return _riccati_solve_parallel_impl(lq, dx0)


def _riccati_solve_parallel_impl(lq: LqProblem, dx0: jax.Array) -> LqSolution:
    T, nx = lq.A.shape[0], lq.A.shape[1]
    dtype = lq.A.dtype

    # Stage elements k = 0..T-1 plus the terminal element.
    Ruu_chol = jnp.linalg.cholesky(lq.Ruu)
    Rinv_Bt = jax.vmap(lambda c, B: jax.scipy.linalg.cho_solve((c, True), B.T))(
        Ruu_chol, lq.B
    )  # (T, nu, nx)
    Rinv_ru = jax.vmap(lambda c, r: jax.scipy.linalg.cho_solve((c, True), r))(
        Ruu_chol, lq.ru
    )  # (T, nu)
    C_stage = lq.B @ Rinv_Bt  # (T, nx, nx)
    b_stage = lq.r - jnp.einsum("kij,kj->ki", lq.B, Rinv_ru)

    zeros_m = jnp.zeros((1, nx, nx), dtype)
    zeros_v = jnp.zeros((1, nx), dtype)
    elems = _ValueElem(
        A=jnp.concatenate([lq.A, zeros_m], axis=0),
        b=jnp.concatenate([b_stage, zeros_v], axis=0),
        C=jnp.concatenate([C_stage, zeros_m], axis=0),
        eta=jnp.concatenate([-lq.qx[:-1], -lq.qx[-1:]], axis=0),
        J=lq.Qxx,
    )

    # Suffix combinations: result[k] = e_k x e_{k+1} x ... x e_T. A reverse
    # associative_scan passes (accumulated-later, earlier) to the combine, so the
    # argument order of _combine(earlier, later) must be swapped here.
    suffix = jax.lax.associative_scan(
        lambda later, earlier: _combine(earlier, later), elems, reverse=True, axis=0
    )
    P = suffix.J  # (T+1, nx, nx)
    p = -suffix.eta  # (T+1, nx)

    # Gains from the (k+1)-suffix value functions (pointwise, fully parallel).
    P_next, p_next = P[1:], p[1:]
    BtP = jnp.swapaxes(lq.B, -1, -2) @ P_next
    Guu = lq.Ruu + BtP @ lq.B
    Gxu_T = BtP @ lq.A  # (T, nu, nx) == Gxu'
    gu = lq.ru + jnp.einsum("kij,kj->ki", jnp.swapaxes(lq.B, -1, -2), jnp.einsum("kij,kj->ki", P_next, lq.r) + p_next)
    chol = jnp.linalg.cholesky(Guu)
    K = -jax.vmap(lambda c, g: jax.scipy.linalg.cho_solve((c, True), g))(chol, Gxu_T)
    kff = -jax.vmap(lambda c, g: jax.scipy.linalg.cho_solve((c, True), g))(chol, gu)

    # Parallel forward rollout: compose affine maps x_{k+1} = F_k x_k + f_k.
    F = lq.A + lq.B @ K
    f = jnp.einsum("kij,kj->ki", lq.B, kff) + lq.r

    def affine_combine(m1, m2):
        # m1 earlier, m2 later: x -> M2 (M1 x + v1) + v2
        M1, v1 = m1
        M2, v2 = m2
        return (M2 @ M1, jnp.einsum("...ij,...j->...i", M2, v1) + v2)

    Ms, vs = jax.lax.associative_scan(affine_combine, (F, f), axis=0)
    dx_path = jnp.einsum("kij,j->ki", Ms, dx0) + vs  # dx_{1..T}
    dx = jnp.concatenate([dx0[None], dx_path], axis=0)
    du = jnp.einsum("kij,kj->ki", K, dx[:-1]) + kff
    return LqSolution(dx=dx, du=du, K=K, kff=kff)
