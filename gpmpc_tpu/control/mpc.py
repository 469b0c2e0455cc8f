"""Nominal nonlinear MPC (full prior model, no GP).

≙ /root/reference/gpmpc/mpc.py:12-193, rebuilt as a JAX program: instead of emitting C via
acados and calling it through ctypes each step, the whole controller step — periodic
reference windowing, SQP with RK4-linearized dynamics, interior-point QP — is one
jitted pure function over an explicit `MpcState`. Episodes `lax.scan` over it and
scenario batches `vmap` over it.

Contracts preserved (SURVEY.md §7):
  * RK4 discretization of the continuous dynamics (mpc.py:75-82)
  * LINEAR_LS cost W = blkdiag(Q, R), W_e = Q, with acados' default dt stage
    scaling (mpc.py:98-110)
  * hard box constraints on state and input (mpc.py:50-55); constraint tolerance
    uh = +1e-8 (mpc.py:157) is represented exactly by the box bounds themselves
  * periodic reference windowing (mpc.py:188-193)
  * SQP with Gauss-Newton Hessian, <= 25 iterations (mpc.py:113-120)
  * U_EQ = [0.3234, 0, 0, 0] input reference (mpc.py:15,41)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.models import quadrotor
from gpmpc_tpu.models.symbolic import SymbolicModel
from gpmpc_tpu.ops.sqp import OcpBounds, OcpCost, SqpConfig, sqp_solve


class MpcConsts(NamedTuple):
    """Traced constants of one MPC problem instance."""

    traj: jax.Array  # (N, nx) periodic reference
    Q: jax.Array  # (nx, nx)
    R: jax.Array  # (nu, nu)
    uref: jax.Array  # (T, nu)
    scale: jax.Array  # (T+1,) cost scaling (acados semantics: [dt...dt, 1])
    lx: jax.Array  # (nx,)
    ux: jax.Array  # (nx,)
    lu: jax.Array  # (nu,)
    uu: jax.Array  # (nu,)


class MpcState(NamedTuple):
    """Controller state threaded through an episode."""

    traj_step: jax.Array  # int32
    X_warm: jax.Array  # (T+1, nx)
    U_warm: jax.Array  # (T, nu)


class MpcInfo(NamedTuple):
    X: jax.Array
    U: jax.Array
    step_norm: jax.Array
    qp_gap: jax.Array
    n_iters: jax.Array
    # Fraction of (stage, dim) box bounds whose chance-constraint tightening hit
    # the feasibility cap this step (0 for the nominal controller). Nonzero means
    # the advertised chance constraint is NOT fully honored — the reference fails
    # hard with an acados status instead (gpmpc/mpc.py:185); here degradation is
    # graceful but must be visible.
    # numpy defaults: jnp here would initialize the XLA backend at import
    clamp_frac: jax.Array = np.float32(0.0)
    # Largest violation of the (tightened) state box at the returned solution.
    # ~0 under hard bounds (the IP keeps strict feasibility); under soft state
    # bounds (SqpConfig.soft_x_penalty) this is the graceful-degradation signal:
    # how far the L1-penalized solve chose to exceed the tightened box.
    soft_viol: jax.Array = np.float32(0.0)
    # KKT residuals at the returned iterate (acados res_eq / res_stat exit
    # semantics; ops/sqp.py::kkt_residuals) and whether the SQP's convergence
    # mask triggered before the iteration cap. A `converged=False` solve is
    # the framework's analogue of a bad acados status (mpc.py:185) — callers
    # deciding to trust the action should check it.
    eq_res: jax.Array = np.float32(np.inf)
    stat_res: jax.Array = np.float32(np.inf)
    converged: jax.Array = np.bool_(True)


def default_u_eq(nu: int, dtype=jnp.float32) -> jax.Array:
    """Fallback initial warm-start input when no model is in scope: quadrotor
    hover trim for nu=4 (bit-compat with the reference contract), zeros
    otherwise. NOTE: only feeds `init_state`'s U_warm, which every solve path
    overwrites before first use (select_action: first step takes consts.uref);
    the cost-relevant input reference comes from the MODEL's own `u_eq`
    (make_consts), never from this dimension heuristic."""
    if nu == quadrotor.NU:
        return quadrotor.U_EQ.astype(dtype)
    return jnp.zeros((nu,), dtype)


def make_consts(
    model: SymbolicModel,
    traj: jax.Array,
    q_mpc,
    r_mpc,
    horizon: int,
    dtype=jnp.float32,
    bounds: tuple | None = None,
    u_eq: jax.Array | None = None,
) -> MpcConsts:
    """Build the traced constants. Defaults keep the reference's quadrotor
    contract (hover-trim U_EQ, quadrotor boxes); other model families pass
    `bounds=((lx, ux), (lu, uu))` and (optionally) their own `u_eq`."""
    assert len(q_mpc) == model.nx and len(r_mpc) == model.nu
    if bounds is None:
        (lx, ux), (lu, uu) = (quadrotor.state_bounds(), quadrotor.input_bounds())
    else:
        (lx, ux), (lu, uu) = bounds
    if u_eq is None:  # the model family's own trim; zero input if it has none
        u_eq = model.u_eq if model.u_eq is not None else jnp.zeros((model.nu,), dtype)
    scale = np.full(horizon + 1, model.dt)
    scale[-1] = 1.0  # terminal stage unscaled (acados cost_scaling default)
    return MpcConsts(
        traj=jnp.asarray(traj, dtype),
        Q=jnp.diag(jnp.asarray(q_mpc, dtype)),
        R=jnp.diag(jnp.asarray(r_mpc, dtype)),
        uref=jnp.tile(jnp.asarray(u_eq, dtype)[None], (horizon, 1)),
        scale=jnp.asarray(scale, dtype),
        lx=jnp.asarray(lx, dtype),
        ux=jnp.asarray(ux, dtype),
        lu=jnp.asarray(lu, dtype),
        uu=jnp.asarray(uu, dtype),
    )


def init_state(
    horizon: int, nx: int = 12, nu: int = 4, dtype=jnp.float32,
    u_eq: jax.Array | None = None,
) -> MpcState:
    if u_eq is None:
        u_eq = default_u_eq(nu, dtype)
    return MpcState(
        traj_step=jnp.asarray(0, jnp.int32),
        X_warm=jnp.zeros((horizon + 1, nx), dtype),
        U_warm=jnp.tile(jnp.asarray(u_eq, dtype)[None], (horizon, 1)),
    )


def reference_window(traj: jax.Array, traj_step: jax.Array, horizon: int) -> jax.Array:
    """Periodic reference window, (T+1, nx). ≙ mpc.py:188-193 (modulo wraparound)."""
    idx = jnp.mod(traj_step + jnp.arange(horizon + 1), traj.shape[0])
    return jnp.take(traj, idx, axis=0)


def select_action(
    model: SymbolicModel,
    cfg: SqpConfig,
    consts: MpcConsts,
    state: MpcState,
    obs: jax.Array,
    bounds_override: OcpBounds | None = None,
) -> tuple[jax.Array, MpcState, MpcInfo]:
    """One MPC step. Pure; jit/vmap/scan-able.

    ≙ MPC.select_action (mpc.py:172-186). Warm start: first solve initializes the
    state trajectory at the current observation (the acados all-zero default guess
    is meaningless under a pure-function API); subsequent solves reuse the previous
    solution, like acados' persistent solver memory.
    """
    T = consts.uref.shape[0]
    xref = reference_window(consts.traj, state.traj_step, T)

    first = state.traj_step == 0
    X_init = jnp.where(first, jnp.tile(obs[None], (T + 1, 1)), state.X_warm)
    U_init = jnp.where(first, consts.uref, state.U_warm)

    if bounds_override is None:
        bounds = OcpBounds(
            lx=jnp.tile(consts.lx[None], (T + 1, 1)),
            ux=jnp.tile(consts.ux[None], (T + 1, 1)),
            lu=jnp.tile(consts.lu[None], (T, 1)),
            uu=jnp.tile(consts.uu[None], (T, 1)),
        )
    else:
        bounds = bounds_override

    cost = OcpCost(
        xref=xref, uref=consts.uref, Q=consts.Q, R=consts.R, Qe=consts.Q, scale=consts.scale
    )
    sol = sqp_solve(model.fd_func, cost, bounds, obs, X_init, U_init, cfg)

    new_state = MpcState(traj_step=state.traj_step + 1, X_warm=sol.X, U_warm=sol.U)
    info = MpcInfo(
        X=sol.X, U=sol.U, step_norm=sol.step_norm, qp_gap=sol.qp_gap, n_iters=sol.n_iters,
        soft_viol=state_bound_violation(sol.X, bounds),
        eq_res=sol.eq_res, stat_res=sol.stat_res, converged=sol.converged,
    )
    return sol.U[0], new_state, info


def state_bound_violation(X: jax.Array, bounds: OcpBounds) -> jax.Array:
    """Largest positive excess of X (stages 1..T; stage 0 is the pinned obs)
    over its per-stage box — the MpcInfo.soft_viol telemetry."""
    lo = jnp.max(bounds.lx[1:] - X[1:])
    hi = jnp.max(X[1:] - bounds.ux[1:])
    return jnp.maximum(jnp.maximum(lo, hi), 0.0)


class MPC:
    """Stateful convenience wrapper mirroring the reference MPC API (mpc.py:12-193)."""

    U_EQ = np.array([0.3234, 0.0, 0.0, 0.0])

    def __init__(
        self,
        symbolic_model: SymbolicModel,
        traj,
        q_mpc,
        r_mpc,
        output_dir=None,
        horizon: int = 5,
        sqp_iters: int = 25,
        qp_iters: int = 15,
        parallel_scan: bool = False,
        bounds: tuple | None = None,
        lm_reg: float = 0.0,
    ):
        self.model = symbolic_model
        self.T = horizon
        self.traj = jnp.asarray(traj)
        if self.traj.shape[0] < self.traj.shape[1]:  # accept (nx, N) like the reference
            self.traj = self.traj.T
        self.output_dir = output_dir
        self.consts = make_consts(
            symbolic_model, self.traj, q_mpc, r_mpc, horizon, bounds=bounds
        )
        self.cfg = SqpConfig(
            sqp_iters=sqp_iters, qp_iters=qp_iters, parallel_scan=parallel_scan,
            lm_reg=lm_reg,
        )
        self.state = init_state(horizon, symbolic_model.nx, symbolic_model.nu)
        self._step = jax.jit(
            partial(select_action, self.model, self.cfg), static_argnames=()
        )

    def reset(self):
        """≙ MPC.reset (mpc.py:60-63)."""
        self.state = init_state(self.T, self.model.nx, self.model.nu)

    def reference_trajectory(self) -> np.ndarray:
        """Reference window at the current step, (nx, T+1). ≙ mpc.py:188-193."""
        return np.asarray(
            reference_window(self.consts.traj, self.state.traj_step, self.T)
        ).T

    def select_action(self, obs) -> np.ndarray:
        obs = jnp.asarray(obs, jnp.float32)
        u, self.state, self._last_info = self._step(self.consts, self.state, obs)
        u = np.asarray(u)
        # ≙ `assert status in [0, 2]` after each acados solve (mpc.py:185): a
        # non-finite solution is the analogue of a failed solver status.
        if not np.all(np.isfinite(u)):
            raise RuntimeError(
                f"MPC solve produced non-finite action {u} "
                f"(step_norm={float(self._last_info.step_norm)})"
            )
        return u
