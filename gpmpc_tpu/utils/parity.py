"""Parity of the QP-kernel path against the plain XLA path at real widths.

Shared by chip_smoke.py and the tests marked `gpu` (tests/test_gpu.py), so
both compile the same programs. Two comparisons:

  * `qp_parity`: QPs taken from a real linearized closed-loop step, solved by
    the Pallas kernel and by `boxqp.solve_ocp_qp` vmapped at HIGHEST matmul
    precision on the host CPU, both to a tight exit; the largest primal
    difference.
  * `closed_loop_parity`: a few closed-loop steps of `batched_gpmpc_step` on
    the kernel path, each compared with the vmapped XLA `select_action` from
    the same state; the action RMSE per step and the kernel path's diagnostics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.control import gpmpc as gpmpc_mod
from gpmpc_tpu.control import mpc as mpc_mod
from gpmpc_tpu.ops.boxqp import OcpQpData, solve_ocp_qp
from gpmpc_tpu.ops.pallas_ocp import solve_ocp_qp_lanes
from gpmpc_tpu.ops.sqp_lanes import linearized_qp, make_linearizer
from gpmpc_tpu.parallel.batch import batched_gpmpc_step
from gpmpc_tpu.utils.benchkit import Problem

# QP parity is checked at a tight exit: the kernel iterates to centering 1e-9
# (30 iterations at most) and the reference to its f32 floor, so both sit at
# the same point of the central path and the difference is arithmetic only.
# At the production exit (centering 1e-6) the kernel stops early by design:
# on cold-start QPs of a real step the primal then differs from the converged
# solution by up to ~1e-2 (kept to the control-parity bar end to end by the
# closed-loop check, not here).
# Soft (L1-penalized) state bounds with Mehrotra get a looser primal bar. The
# QP is strictly convex in u, so its solution is unique, but the kernel's
# soft Mehrotra iteration floors its centering target at 1e-8 (scenarios that
# finish keep iterating while their block-mates do, and must keep a barrier
# that f32 can factor), so it stops at a mean gap of up to 5e-8. Along the
# weakly weighted rate states (Q = 1e-3) that gap leaves the primal ~1e-3 from
# the optimum: 1.05e-3 on one quadrotor scenario, on the H100 and in
# interpret mode alike, against a converged float64 boxqp, while the f32
# boxqp reference is within 5.6e-5 of it and the kernel's fixed-centering
# soft path within 7e-7.
QP_EXIT_TOL = 1e-9
QP_ITERS = 30
QP_TOL = 1e-4
QP_SOFT_MEHROTRA_TOL = 2e-3
# Closed-loop action RMSE allowed between the kernel path and the XLA path
# (the control-parity bar).
ACTION_RMSE_TOL = 1e-3


def initial_states(problem: Problem, B: int, seed: int = 0):
    """B scenarios reset from `seed`: (env_states, ctrl_states, obs)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    env_states, obs = jax.vmap(lambda k: problem.env_reset(problem.env_params, k))(keys)
    T = problem.ctrl.T
    model = problem.model
    ctrl_states = jax.vmap(lambda _: mpc_mod.init_state(T, model.nx, model.nu))(
        jnp.arange(B)
    )
    return env_states, ctrl_states, obs


def step_qp(problem: Problem, B: int, soft_rho: float | None = None, seed: int = 0):
    """The first-iteration QP of a closed-loop step for B scenarios, with the
    chance-constraint tightening active (scenario-last LanesQp)."""
    model, ctrl, gp = problem.model, problem.ctrl, problem.gp
    _, states, obs = initial_states(problem, B, seed)
    T = ctrl.T
    # One step in: the warm start is the observation held over the horizon and
    # the tightening is on (it is off at the very first step by contract).
    states = states._replace(
        traj_step=jnp.ones_like(states.traj_step),
        X_warm=jnp.tile(obs[:, None], (1, T + 1, 1)),
    )

    @jax.jit
    def build(states, obs):
        xref, bounds, X_init, U_init, _ = gpmpc_mod.batched_prepare_step(
            model, ctrl.consts, gp, states, obs, soft=soft_rho is not None
        )
        c = ctrl.consts.mpc
        cost = mpc_mod.OcpCost(xref=xref, uref=c.uref, Q=c.Q, R=c.R, Qe=c.Q, scale=c.scale)
        fd = functools.partial(gpmpc_mod.augmented_fd, model, gp)
        X = X_init.at[:, 0, :].set(obs)
        qp, _ = linearized_qp(make_linearizer(fd), cost, bounds, X, U_init, ctrl.cfg.lm_reg)
        return qp

    with jax.default_matmul_precision("highest"):  # as on the kernel path
        return build(states, obs)


@functools.partial(jax.jit, static_argnames=("n_iter", "mehrotra", "soft_x"))
def reference_qp_solve(qp, n_iter: int, mehrotra: bool, soft_x):
    """boxqp.solve_ocp_qp per scenario at HIGHEST matmul precision;
    scenario-last in and out, like the kernel."""
    def one(A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu):
        data = OcpQpData(
            A=A, B=B, r=r, Qxx=jax.vmap(jnp.diag)(qdiag), qx=qx,
            Ruu=jax.vmap(jnp.diag)(rdiag), ru=ru, lx=lx, ux=ux, lu=lu, uu=uu,
        )
        sol = solve_ocp_qp(data, n_iter=n_iter, mehrotra=mehrotra, soft_x=soft_x)
        return sol.dx, sol.du

    first = [jnp.moveaxis(a, -1, 0) for a in qp]
    with jax.default_matmul_precision("highest"):
        dx, du = jax.vmap(one)(*first)
    return jnp.moveaxis(dx, 0, -1), jnp.moveaxis(du, 0, -1)


def host_device():
    """Where the QP reference runs: the host's CPU when JAX has that backend
    (XLA:CPU compiles the reference in seconds where XLA:GPU took minutes at
    T=200, and its f32 arithmetic is independent of the card's), else the
    default device."""
    try:
        return jax.devices("cpu")[0]
    except RuntimeError:
        return jax.devices()[0]


def qp_parity(qp, cfg, soft_rho: float | None = None, interpret: bool = False) -> dict:
    """Kernel at the tight exit vs the converged reference on the same QP
    batch (cfg supplies the Mehrotra setting). interpret=True runs the kernel
    in Pallas interpret mode (CPU rehearsal)."""
    dx, du, gap = solve_ocp_qp_lanes(
        qp, n_ip=QP_ITERS, adaptive_tol=QP_EXIT_TOL, mehrotra=cfg.qp_mehrotra,
        soft_rho=soft_rho, interpret=interpret,
    )
    # XLA:CPU executables are specific to the host that compiled them: keep
    # the reference's out of the persistent compile cache.
    key = "jax_persistent_cache_min_compile_time_secs"
    min_time = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        rdx, rdu = reference_qp_solve(
            jax.device_put(qp, host_device()), QP_ITERS, cfg.qp_mehrotra, soft_rho
        )
    finally:
        jax.config.update(key, min_time)
    return {
        "err_dx": max_abs(dx, rdx),
        "err_du": max_abs(du, rdu),
        "gap_max": float(jnp.max(gap)),
        "finite": bool(jnp.all(jnp.isfinite(dx)) and jnp.all(jnp.isfinite(du))),
    }


def qp_tol(soft: bool, mehrotra: bool) -> float:
    """The primal QP parity bar (see QP_SOFT_MEHROTRA_TOL)."""
    return QP_SOFT_MEHROTRA_TOL if soft and mehrotra else QP_TOL


def qp_parity_ok(res: dict, soft: bool, mehrotra: bool) -> bool:
    return res["finite"] and max(res["err_dx"], res["err_du"]) <= qp_tol(soft, mehrotra)


def closed_loop_parity(
    problem: Problem, B: int, n_steps: int = 3, seed: int = 0, interpret: bool = False
):
    """Chained closed-loop steps on the kernel path; at each step the XLA
    path solves from the same state. Returns (per-step records, the compiled
    kernel-path step). interpret=True is the CPU rehearsal."""
    model, ctrl, gp = problem.model, problem.ctrl, problem.gp
    env_p, env_step = problem.env_params, problem.env_step

    def kernel_step(consts, gpm, env_states, ctrl_states, obs):
        u, ctrl_states, info = batched_gpmpc_step(
            model, ctrl.cfg, consts, gpm, ctrl_states, obs, backend="lanes",
            interpret=interpret,
        )
        env_states, obs, _, _, _ = jax.vmap(lambda s, a: env_step(env_p, s, a))(
            env_states, u
        )
        return env_states, ctrl_states, obs, u, info

    def xla_action(consts, gpm, ctrl_states, obs):
        u, _, _ = batched_gpmpc_step(
            model, ctrl.cfg, consts, gpm, ctrl_states, obs, backend="xla"
        )
        return u

    env_states, ctrl_states, obs = initial_states(problem, B, seed)
    args = (ctrl.consts, gp, env_states, ctrl_states, obs)
    kernel = jax.jit(kernel_step).lower(*args).compile()
    xla = jax.jit(xla_action)
    records = []
    for k in range(n_steps):
        u_x = xla(ctrl.consts, gp, ctrl_states, obs)
        env_states, ctrl_states, obs, u, info = kernel(
            ctrl.consts, gp, env_states, ctrl_states, obs
        )
        rmse = float(jnp.sqrt(jnp.mean((u - u_x) ** 2)))
        diag_finite = all(
            bool(jnp.all(jnp.isfinite(getattr(info, f))))
            for f in ("qp_gap", "step_norm", "eq_res", "stat_res", "soft_viol")
        )
        records.append({
            "step": k, "action_rmse": rmse,
            "finite": bool(jnp.all(jnp.isfinite(u))) and diag_finite,
            "sqp_iters_max": int(jnp.max(info.n_iters)),
            "qp_gap_max": float(jnp.max(info.qp_gap)),
        })
    return records, kernel


def rollout_trained_gp(problem: Problem, steps: int = 60, iterations: int = 500):
    """GPs trained as the learning loop trains them: a prior-controller
    rollout of `steps` transitions on the problem's plant, then the config
    default of 500 Adam iterations. On the quadrotor this drives two of the
    three noises to ~1e-3 and below, with GP-mean weights of ~1e2. Returns
    (gp, the trained noise per GP)."""
    ctrl, env = problem.ctrl, problem.env
    obs, _ = env.reset(seed=0)
    X, U = [np.asarray(obs)], []
    for _ in range(steps):
        u = ctrl.prior_ctrl.select_action(np.asarray(obs))
        obs, *_ = env.step(jnp.asarray(u))
        X.append(np.asarray(obs))
        U.append(np.asarray(u))
    X = np.asarray(X)
    xi, yi = ctrl.preprocess_data(X[:-1], np.asarray(U), X[1:])
    ctrl.train_gp(xi, yi, lr=0.05, iterations=iterations)
    gp = ctrl.gp_model
    noise = np.asarray(jax.nn.softplus(gp.hypers.raw_noise)) + 1e-6
    return gp, noise


def action_rmse_ok(records) -> bool:
    return all(r["finite"] and r["action_rmse"] <= ACTION_RMSE_TOL for r in records)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
