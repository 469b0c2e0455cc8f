"""SQP solver for nonlinear trajectory-tracking OCPs.

JAX replacement for the acados SQP runtime (configured by the reference at
/root/reference/gpmpc/mpc.py:113-120: Gauss-Newton Hessian, DISCRETE integrator,
nlp_solver_type="SQP", max 25 iterations, fixed full steps). Each iteration
linearizes the discrete dynamics with `jax.jacfwd` (replacing CasADi symbolic
Jacobians + acados C codegen — jit tracing *is* the codegen) and solves a
box-constrained LQ-QP with the interior-point solver in `boxqp.py`.

Everything is fixed-shape and fixed-iteration-count with a convergence mask, so a
single compiled program serves every solve; batching over scenarios is `vmap`, and
there is no per-model recompile (the reference pays a C-codegen + dlopen cycle per
GP retrain, /root/reference/gpmpc/gpmpc.py:97-108).

Cost convention (matches acados LINEAR_LS with Vx/Vu selection, W = blkdiag(Q, R),
W_e = Q, /root/reference/gpmpc/mpc.py:98-110): stage costs are scaled by dt and the
terminal cost by 1, mirroring acados' default `cost_scaling = [dt, ..., dt, 1]`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.ops.boxqp import BOUND_INF, OcpQpData, solve_ocp_qp


class SqpConfig(NamedTuple):
    sqp_iters: int = 25  # ≙ nlp_solver_max_iter (mpc.py:119)
    qp_iters: int = 15
    step_tol: float = 1e-6
    parallel_scan: bool = False  # O(log T) associative-scan Riccati (long horizons)
    # Stop iterating once converged (lax.while_loop) instead of running masked
    # no-op iterations to the fixed count. This matches acados semantics — its SQP
    # exits at tolerance, max_iter is a cap — and is where warm-started MPC wins:
    # steady-state solves converge in 2-3 iterations.
    early_exit: bool = True
    # In-kernel adaptive IP exit for the QP kernel (lanes backend): once every
    # scenario of a block has its centering parameter below this, the block's
    # remaining IP iterations are skipped. None = fixed qp_iters count (the
    # XLA backend always runs the fixed count).
    qp_tol: float | None = None
    # Use analytic dynamics Jacobians (models/jacobians.py) instead of jacfwd in
    # the lanes backend; quadrotor models only (other families fall back).
    analytic_jac: bool = False
    # Mehrotra predictor-corrector in the IP QP (both backends): two Riccati
    # sweeps per iteration, per-scenario adaptive centering, fewer iterations to
    # a given gap (HPIPM's scheme; pair with qp_tol on the lanes backend).
    qp_mehrotra: bool = False
    # L1 penalty weight that makes the STATE bounds soft (slack-penalized, the
    # HPIPM bounded-multiplier formulation in ops/boxqp.py) so aggressive
    # chance-constraint tightening degrades gracefully instead of producing an
    # infeasible QP. None = hard bounds. Input bounds are always hard (they are
    # actuator limits). Both backends support it at any horizon.
    soft_x_penalty: float | None = None
    # Levenberg-Marquardt regularization (≙ acados
    # ocp.solver_options.levenberg_marquardt): lm_reg * I is added to the
    # Gauss-Newton Hessian blocks (NOT the gradient), penalizing step length
    # toward the current iterate. Full-step GN SQP can limit-cycle on strongly
    # nonlinear OCPs (measured on the two-link arm with a large learned
    # residual: step_norm ~6 oscillation from mid-trajectory on); a small
    # lm_reg restores contraction at negligible per-iteration cost. 0 = off
    # (acados' default).
    lm_reg: float = 0.0
    # RTI-style warm-start shift: initialize the SQP from the previous solution
    # advanced by one stage (X[1:] + repeated terminal state) so the warm start
    # is time-aligned with the new problem. The tightening still linearizes
    # around the UNSHIFTED previous solution (reference semantics,
    # gpmpc.py:438). Off by default: matches the reference's unshifted acados
    # warm start.
    warm_shift: bool = False
    # KKT-residual exit criteria (acados residual semantics: nlp_solver_tol_eq /
    # tol_stat, ≙ the solver options at /root/reference/gpmpc/mpc.py:113-120).
    # When set, convergence additionally requires the dynamics-feasibility
    # residual max|fd(x_k, u_k) - x_{k+1}| (res_eq) and the projected-gradient
    # stationarity residual (res_stat, computed from exact adjoint costates —
    # see sqp_solve) to drop below this tolerance; a solve that exhausts
    # sqp_iters with residuals above it reports converged=False in SqpSolution/
    # MpcInfo instead of silently returning. None = step-norm-only exit (the
    # round-2 behavior).
    kkt_tol: float | None = None


class OcpCost(NamedTuple):
    """Tracking cost data. scale: (T+1,) per-stage cost scaling (acados semantics)."""

    xref: jax.Array  # (T+1, nx)
    uref: jax.Array  # (T, nu)
    Q: jax.Array  # (nx, nx)
    R: jax.Array  # (nu, nu)
    Qe: jax.Array  # (nx, nx) terminal weight
    scale: jax.Array  # (T+1,)


class OcpBounds(NamedTuple):
    """Per-stage box bounds (already tightened if applicable)."""

    lx: jax.Array  # (T+1, nx)
    ux: jax.Array  # (T+1, nx)
    lu: jax.Array  # (T, nu)
    uu: jax.Array  # (T, nu)


class SqpSolution(NamedTuple):
    X: jax.Array  # (T+1, nx)
    U: jax.Array  # (T, nu)
    step_norm: jax.Array  # last accepted step inf-norm
    qp_gap: jax.Array  # last QP complementarity gap
    n_iters: jax.Array  # iterations until convergence mask triggered
    # KKT residuals at the last active iterate (acados res_eq / res_stat):
    # max dynamics defect and projected-gradient stationarity (see
    # kkt_residuals). inf until the first iteration evaluates them.
    # numpy defaults: jnp here would initialize the XLA backend at import
    eq_res: jax.Array = np.float32(np.inf)
    stat_res: jax.Array = np.float32(np.inf)
    # Whether the convergence mask triggered before the iteration cap (always
    # checks step_norm < step_tol; with cfg.kkt_tol also both residuals).
    converged: jax.Array = np.bool_(True)


def kkt_residuals(
    A: jax.Array,  # (T, nx, nx) discrete dynamics Jacobians at the iterate
    B: jax.Array,  # (T, nx, nu)
    defect: jax.Array,  # (T, nx) fd(x_k, u_k) - x_{k+1}
    qx: jax.Array,  # (T+1, nx) cost gradient d l / dx (incl. terminal)
    ru: jax.Array,  # (T, nu) cost gradient d l / du
    U: jax.Array,  # (T, nu) current inputs
    lu: jax.Array,  # (T, nu) input bounds
    uu: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """(eq_res, stat_res) at the current SQP iterate.

    eq_res = max |fd(x_k, u_k) - x_{k+1}| — the NLP's dynamics feasibility
    (acados res_eq; box feasibility is maintained by construction, the QP's
    delta bounds keep every accepted iterate inside its box).

    stat_res: costates are recovered EXACTLY from the state-stationarity
    recursion lam_k = qx_k + A_k' lam_{k+1} (the multipliers of inactive state
    bounds are zero and active state bounds' are absorbed into lam — the
    standard adjoint elimination), then input stationarity is measured as the
    projected-gradient norm max |u - P_[lu,uu](u - (ru + B' lam))|, which is
    zero iff u satisfies its first-order conditions under the box. This is
    acados' res_stat modulo the state-bound absorption, and — unlike the
    step-norm — it cannot be fooled by a stalled QP returning a tiny step at a
    non-stationary point.
    """
    eq_res = jnp.max(jnp.abs(defect))

    def back(lam_next, ops):
        A_k, B_k, qx_k, ru_k = ops
        gu = ru_k + B_k.T @ lam_next
        lam = qx_k + A_k.T @ lam_next
        return lam, gu

    lam_T = qx[-1]
    _, gu = jax.lax.scan(back, lam_T, (A, B, qx[:-1], ru), reverse=True)
    proj = jnp.clip(U - gu, lu, uu)
    stat_res = jnp.max(jnp.abs(U - proj))
    return eq_res, stat_res


def sqp_solve(
    fd: Callable[[jax.Array, jax.Array], jax.Array],
    cost: OcpCost,
    bounds: OcpBounds,
    x0: jax.Array,
    X_init: jax.Array,
    U_init: jax.Array,
    cfg: SqpConfig,
) -> SqpSolution:
    """Solve the tracking OCP by Gauss-Newton SQP with full steps."""
    T = U_init.shape[0]
    nx = X_init.shape[1]
    dtype = X_init.dtype

    fd_jac = jax.vmap(jax.jacfwd(lambda x, u: fd(x, u), argnums=(0, 1)))
    fd_batch = jax.vmap(fd)

    stage_Q = cost.scale[:-1, None, None] * cost.Q[None]
    term_Q = (cost.scale[-1] * cost.Qe)[None]
    Qxx = jnp.concatenate([stage_Q, term_Q], axis=0)  # (T+1, nx, nx)
    Ruu = cost.scale[:-1, None, None] * cost.R[None]  # (T, nu, nu)
    # LM damping enters the QP Hessian only — gradients (and the KKT residuals
    # built from them) stay those of the true cost, so lm_reg changes the step,
    # never the stationary point (≙ acados levenberg_marquardt).
    if cfg.lm_reg:
        Qxx_h = Qxx + cfg.lm_reg * jnp.eye(nx, dtype=dtype)[None]
        Ruu_h = Ruu + cfg.lm_reg * jnp.eye(U_init.shape[1], dtype=dtype)[None]
    else:
        Qxx_h, Ruu_h = Qxx, Ruu

    # Pin x0 exactly (≙ lbx = ubx = obs at stage 0, mpc.py:174-175): stage-0 state is
    # not a decision variable, so its delta bounds are disabled.
    big = jnp.full((1, nx), BOUND_INF, dtype)

    def body(carry, _):
        X, U, converged, step_norm, qp_gap, n_iters, eq_res, stat_res = carry
        X = X.at[0].set(x0)

        A, B = fd_jac(X[:-1], U)
        defect = fd_batch(X[:-1], U) - X[1:]

        ex = X - cost.xref
        eu = U - cost.uref
        qx = jnp.einsum("kij,kj->ki", Qxx, ex)
        ru = jnp.einsum("kij,kj->ki", Ruu, eu)

        # KKT residuals of the CURRENT iterate (≙ acados' residual-based exit);
        # when the step below is tiny, this iterate IS the returned solution.
        new_eq, new_stat = kkt_residuals(
            A, B, defect, qx, ru, U, bounds.lu, bounds.uu
        )

        qp = OcpQpData(
            A=A,
            B=B,
            r=defect,
            Qxx=Qxx_h,
            qx=qx,
            Ruu=Ruu_h,
            ru=ru,
            lx=jnp.concatenate([-big, bounds.lx[1:] - X[1:]], axis=0),
            ux=jnp.concatenate([big, bounds.ux[1:] - X[1:]], axis=0),
            lu=bounds.lu - U,
            uu=bounds.uu - U,
        )
        sol = solve_ocp_qp(
            qp, n_iter=cfg.qp_iters, parallel_scan=cfg.parallel_scan,
            mehrotra=cfg.qp_mehrotra, soft_x=cfg.soft_x_penalty,
        )

        new_step = jnp.maximum(jnp.max(jnp.abs(sol.dx)), jnp.max(jnp.abs(sol.du)))
        # Full Newton-type step (acados FIXED_STEP globalization); frozen once the
        # convergence mask triggers so extra fixed iterations are no-ops.
        active = jnp.logical_not(converged)
        X_new = jnp.where(active, X + sol.dx, X)
        U_new = jnp.where(active, U + sol.du, U)
        step_norm = jnp.where(active, new_step, step_norm)
        qp_gap = jnp.where(active, sol.gap, qp_gap)
        eq_res = jnp.where(active, new_eq, eq_res)
        stat_res = jnp.where(active, new_stat, stat_res)
        n_iters = n_iters + active.astype(jnp.int32)
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
        jnp.asarray(False),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(jnp.inf, dtype),
    )
    if cfg.early_exit:
        def cond(carry):
            converged, n_iters = carry[2], carry[5]
            return jnp.logical_and(n_iters < cfg.sqp_iters, jnp.logical_not(converged))

        (X, U, converged, step_norm, qp_gap, n_iters, eq_res, stat_res) = (
            jax.lax.while_loop(cond, lambda c: body(c, None)[0], init)
        )
    else:
        (X, U, converged, step_norm, qp_gap, n_iters, eq_res, stat_res), _ = (
            jax.lax.scan(body, init, None, length=cfg.sqp_iters)
        )
    X = X.at[0].set(x0)
    return SqpSolution(
        X=X, U=U, step_norm=step_norm, qp_gap=qp_gap, n_iters=n_iters,
        eq_res=eq_res, stat_res=stat_res, converged=converged,
    )
