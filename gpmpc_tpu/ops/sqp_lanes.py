"""Batched SQP with the scenario-blocked Pallas QP backend.

Same Gauss-Newton SQP semantics as `sqp.sqp_solve` (full steps, masked
convergence), but organized batch-first: dynamics linearization runs as one big
vmapped `jacfwd` over all B*T stage points (elementwise-over-batch XLA code that
fuses into a few kernels per SQP iteration), and the QP solves of the whole
batch go through ONE launch of `pallas_ocp.solve_ocp_qp_lanes` (the part XLA
handles badly — see pallas_ocp.py). The kernel's stage loops serve any horizon.

Requires diagonal Q/R stage costs (always true for this framework's LINEAR_LS
tracking cost + IP barrier).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops.boxqp import BOUND_INF
from gpmpc_tpu.ops.pallas_ocp import LanesQp, solve_ocp_qp_lanes
from gpmpc_tpu.ops.sqp import (
    OcpBounds,
    OcpCost,
    SqpConfig,
    SqpSolution,
    kkt_residuals,
)


def _solve_qp_lanes(qp: LanesQp, cfg: SqpConfig, interpret: bool):
    return solve_ocp_qp_lanes(
        qp, n_ip=cfg.qp_iters, adaptive_tol=cfg.qp_tol,
        mehrotra=cfg.qp_mehrotra, soft_rho=cfg.soft_x_penalty,
        interpret=interpret,
    )


def _to_lanes(x: jax.Array) -> jax.Array:
    """(B, ...) -> (..., B): the kernel's scenario-last layout."""
    return jnp.moveaxis(x, 0, -1)


def _from_lanes(x: jax.Array) -> jax.Array:
    """(..., B) -> (B, ...)."""
    return jnp.moveaxis(x, -1, 0)


def make_linearizer(fd=None, fd_jac3=None, linearize_fn=None):
    """Whole-batch (X (B,T,nx), U (B,T,nu)) -> (fnext, A, B) evaluator:
    linearize_fn as given, else vmapped fd_jac3, else vmapped jacfwd of fd."""
    if linearize_fn is not None:
        return linearize_fn
    if fd_jac3 is not None:
        return jax.vmap(jax.vmap(fd_jac3))
    fd_jac = jax.vmap(jax.vmap(jax.jacfwd(fd, argnums=(0, 1))))
    fd_batch = jax.vmap(jax.vmap(fd))

    def linearize(X, U):
        A, Bm = fd_jac(X, U)
        return fd_batch(X, U), A, Bm

    return linearize


def linearized_qp(linearize, cost: OcpCost, bounds: OcpBounds, X, U, lm_reg=0.0):
    """The QP of one SQP iteration at the iterate (X (B,T+1,nx) with X[:, 0]
    pinned to x0, U (B,T,nu)), in the kernel's scenario-last layout, and the
    iterate's per-scenario KKT residuals (eq, stat)."""
    B = X.shape[0]
    q_diag_stage = jnp.diagonal(cost.Q)  # (nx,)
    qe_diag = jnp.diagonal(cost.Qe)
    r_diag = jnp.diagonal(cost.R)
    scale = cost.scale  # (T+1,)
    qdiag = jnp.concatenate(
        [scale[:-1, None] * q_diag_stage[None], (scale[-1] * qe_diag)[None]], axis=0
    )  # (T+1, nx)
    rdiag = scale[:-1, None] * r_diag[None]  # (T, nu)
    big = jnp.asarray(BOUND_INF, X.dtype)

    with jax.named_scope("linearize"):
        fnext, A, Bm = linearize(X[:, :-1], U)  # (B,T,nx), (B,T,nx,nx), (B,T,nx,nu)
    defect = fnext - X[:, 1:]
    qx = qdiag[None] * (X - cost.xref)  # (B, T+1, nx)
    ru = rdiag[None] * (U - cost.uref)
    # Per-scenario KKT residuals of the current iterate (ops/sqp.py).
    eq, stat = jax.vmap(kkt_residuals)(A, Bm, defect, qx, ru, U, bounds.lu, bounds.uu)
    lx = (bounds.lx - X).at[:, 0, :].set(-big)
    ux = (bounds.ux - X).at[:, 0, :].set(big)
    # LM damping: Hessian diagonal only, gradient/KKT stay undamped
    # (ops/sqp.py SqpConfig.lm_reg).
    qdiag_h = jnp.broadcast_to((qdiag + lm_reg)[None], (B,) + qdiag.shape)
    rdiag_h = jnp.broadcast_to((rdiag + lm_reg)[None], (B,) + rdiag.shape)
    qp = LanesQp(*(_to_lanes(a) for a in (
        A, Bm, defect, qdiag_h, qx, rdiag_h, ru, lx, ux, bounds.lu - U, bounds.uu - U,
    )))
    return qp, (eq, stat)


def sqp_solve_batch_lanes(
    fd: Callable[[jax.Array, jax.Array], jax.Array],
    cost: OcpCost,  # leaves batched over B (xref/uref) or shared (Q/R/scale)
    bounds: OcpBounds,  # leaves batched over B
    x0: jax.Array,  # (B, nx)
    X_init: jax.Array,  # (B, T+1, nx)
    U_init: jax.Array,  # (B, T, nu)
    cfg: SqpConfig,
    interpret: bool = False,
    fd_jac3=None,
    linearize_fn=None,
) -> SqpSolution:
    """Batch SQP solve; returns SqpSolution with leaves batched over B.

    fd_jac3: optional (x, u) -> (fnext, A, B) combined evaluator (analytic
    Jacobians, models/jacobians.py); default differentiates fd with jacfwd.
    linearize_fn: optional whole-batch (X (B,T,nx), U (B,T,nu)) ->
    (fnext, A, B) evaluator, for dynamics that differ per scenario (e.g. a
    per-scenario GP population); overrides fd/fd_jac3.
    """
    B = X_init.shape[0]
    dtype = X_init.dtype
    linearize = make_linearizer(fd, fd_jac3, linearize_fn)

    def body(carry, _):
        X, U, converged, step_norm, qp_gap, n_iters, eq_res, stat_res = carry
        X = X.at[:, 0, :].set(x0)
        qp, (new_eq, new_stat) = linearized_qp(linearize, cost, bounds, X, U, cfg.lm_reg)
        with jax.named_scope("qp_kernel"):
            dx, du, gap = _solve_qp_lanes(qp, cfg, interpret)
        dx = _from_lanes(dx)  # (B, T+1, nx)
        du = _from_lanes(du)

        new_step = jnp.maximum(
            jnp.max(jnp.abs(dx), axis=(1, 2)), jnp.max(jnp.abs(du), axis=(1, 2))
        )  # (B,)
        active = jnp.logical_not(converged)[:, None, None]
        X_new = jnp.where(active, X + dx, X)
        U_new = jnp.where(active, U + du, U)
        step_norm = jnp.where(active[:, 0, 0], new_step, step_norm)
        qp_gap = jnp.where(active[:, 0, 0], gap, qp_gap)
        eq_res = jnp.where(active[:, 0, 0], new_eq, eq_res)
        stat_res = jnp.where(active[:, 0, 0], new_stat, stat_res)
        n_iters = n_iters + active[:, 0, 0].astype(jnp.int32)
        step_ok = new_step < cfg.step_tol
        if cfg.kkt_tol is not None:
            step_ok = jnp.logical_and(
                step_ok,
                jnp.logical_and(new_eq < cfg.kkt_tol, new_stat < cfg.kkt_tol),
            )
        converged = jnp.logical_or(converged, step_ok)
        return (
            X_new, U_new, converged, step_norm, qp_gap, n_iters, eq_res, stat_res,
        ), None

    init = (
        X_init,
        U_init,
        jnp.zeros((B,), bool),
        jnp.full((B,), jnp.inf, dtype),
        jnp.full((B,), jnp.inf, dtype),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), jnp.inf, dtype),
        jnp.full((B,), jnp.inf, dtype),
    )
    if cfg.early_exit:
        def cond(carry):
            converged, n_iters = carry[2], carry[5]
            return jnp.logical_and(
                jnp.max(n_iters) < cfg.sqp_iters, jnp.logical_not(jnp.all(converged))
            )

        (X, U, converged, step_norm, qp_gap, n_iters, eq_res, stat_res) = (
            jax.lax.while_loop(cond, lambda c: body(c, None)[0], init)
        )
    else:
        (X, U, converged, step_norm, qp_gap, n_iters, eq_res, stat_res), _ = (
            jax.lax.scan(body, init, None, length=cfg.sqp_iters)
        )
    X = X.at[:, 0, :].set(x0)
    return SqpSolution(
        X=X, U=U, step_norm=step_norm, qp_gap=qp_gap, n_iters=n_iters,
        eq_res=eq_res, stat_res=stat_res, converged=converged,
    )
