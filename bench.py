"""Headline benchmark: closed-loop GP-MPC solves/sec on one device.

Runs the full per-step GP-MPC pipeline (chance-constraint covariance propagation +
residual-GP-augmented SQP with interior-point QPs) plus the plant step for a batch
of scenarios as one jitted program, and reports aggregate solves/sec.

Problem size matches the reference default config (SURVEY.md §6): horizon T=25,
nx=12, nu=4, 3 GPs with 40 FITC inducing points, B=1024 scenarios. The step path
(QP kernel on a GPU, XLA on the CPU) is `parallel/batch.py::dispatch_decision`'s.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

_T0 = time.perf_counter()


def _progress(msg: str):
    """Phase progress to stderr, so a slow run shows where it is."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def main():
    _progress("importing jax")
    import jax

    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from gpmpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.parallel.batch import batched_gpmpc_step
    from gpmpc_tpu.utils.benchkit import build_problem

    # Problem-size overrides (BASELINE configs): defaults are the reference
    # problem (T=25, 128-capacity GP, 40 FITC inducing). Config 4 ("2x horizon,
    # >=5k-point GP"): BENCH_HORIZON=50 BENCH_GP_POINTS=5120 BENCH_GP_INDUCING=128.
    horizon = int(os.environ.get("BENCH_HORIZON", "25"))
    gp_points = int(os.environ.get("BENCH_GP_POINTS", "128"))
    gp_inducing = int(os.environ.get("BENCH_GP_INDUCING", "40"))
    gp_data = int(os.environ.get("BENCH_GP_DATA", str(min(gp_points, 5000))))

    # BENCH_MODEL=cartpole|twolink benches the other families through the
    # identical pipeline; default is the reference's quadrotor problem.
    bench_model = os.environ.get("BENCH_MODEL", "quadrotor")

    def build():
        return build_problem(bench_model, horizon, gp_points, gp_inducing, gp_data)

    env, model, ctrl, gp, env_p, env_step_fn, env_reset_fn = build()

    # BENCH_REAL_GP=1: replace the synthetic GP with one trained from a REAL
    # prior-controller rollout (collection, preprocessing and GP training on a
    # second controller instance); the timed program is the same either way.
    if os.environ.get("BENCH_REAL_GP", "0") == "1":
        _progress("BENCH_REAL_GP=1: prior rollout + GP training")
        env_c, model_c, ctrl_c, _, env_p_c, step_c, reset_c = build()
        n_collect = int(os.environ.get("BENCH_REAL_GP_STEPS", "120"))
        key = jax.random.PRNGKey(7)
        st, ob = reset_c(env_p_c, key)
        X, U = [np.asarray(ob)], []
        for _ in range(n_collect):
            u = ctrl_c.prior_ctrl.select_action(np.asarray(ob))
            st, ob, _, _, _ = step_c(env_p_c, st, jnp.asarray(u))
            X.append(np.asarray(ob))
            U.append(u)
        xi, ti = ctrl_c.preprocess_data(
            np.asarray(X[:-1]), np.asarray(U), np.asarray(X[1:])
        )
        ctrl_c.train_gp(xi, ti, lr=0.05, iterations=100)
        gp = ctrl_c.gp_model
        _progress(f"BENCH_REAL_GP: trained on {len(U)} real transitions")
    B = int(os.environ.get("BENCH_BATCH", "1024"))
    n_timed_steps = int(
        os.environ.get("BENCH_STEPS", str(max(60, (60 * 1024) // max(B, 1))))
    )
    backend = os.environ.get("BENCH_BACKEND", "auto")  # auto | lanes | xla
    # In-kernel adaptive IP exit (default 1e-6, benchkit.BENCH_QP_TOL):
    # BENCH_QP_TOL=0 disables it (fixed iterations).
    qp_tol = float(os.environ.get("BENCH_QP_TOL", str(ctrl.cfg.qp_tol)))
    ctrl.cfg = ctrl.cfg._replace(qp_tol=qp_tol if qp_tol > 0 else None)
    if os.environ.get("BENCH_MEHROTRA", "1") != "1":
        ctrl.cfg = ctrl.cfg._replace(qp_mehrotra=False)
    if os.environ.get("BENCH_PSCAN", "0") == "1":
        # O(log T) associative-scan Riccati inside the XLA backend's Newton
        # solves (ops/riccati_parallel.py).
        ctrl.cfg = ctrl.cfg._replace(parallel_scan=True)
    if os.environ.get("BENCH_WARM_SHIFT", "0") == "1":
        # RTI-style time-aligned warm start (ops/sqp.py SqpConfig.warm_shift).
        ctrl.cfg = ctrl.cfg._replace(warm_shift=True)
    if os.environ.get("BENCH_ANALYTIC_JAC", "0") == "1":
        # analytic dynamics Jacobians (models/jacobians.py) instead of jacfwd.
        ctrl.cfg = ctrl.cfg._replace(analytic_jac=True)

    # Closed-loop step: controller solve + plant integration, so every timed
    # solve sees a genuinely new observation (honest steady-state MPC load —
    # with early-exit SQP, re-solving an unchanged problem would be free).
    var_bf16 = os.environ.get("BENCH_VAR_BF16", "0") == "1"

    def closed_loop_step(consts, gpm, env_states, ctrl_states, obs):
        u, ctrl_states, _ = batched_gpmpc_step(
            model, ctrl.cfg, consts, gpm, ctrl_states, obs, backend=backend,
            var_bf16=var_bf16,
        )
        env_states, obs, _, _, _ = jax.vmap(lambda s, a: env_step_fn(env_p, s, a))(
            env_states, u
        )
        return env_states, ctrl_states, obs, u

    # BENCH_FUSED=1: scan the whole timed window inside ONE jitted program (a
    # lax.scan of closed-loop steps, the batched_episode deployment shape)
    # instead of a host loop of chained steps. BENCH_FUSED_UNROLL=<n|full>
    # controls scan unrolling.
    fused = os.environ.get("BENCH_FUSED", "0") == "1"
    if fused:
        fused_unroll = os.environ.get("BENCH_FUSED_UNROLL", "1")
        unroll = True if fused_unroll == "full" else int(fused_unroll)

        def fused_window(consts, gpm, env_states, ctrl_states, obs, n):
            def body(carry, _):
                env_states, ctrl_states, obs = carry
                env_states, ctrl_states, obs, u = closed_loop_step(
                    consts, gpm, env_states, ctrl_states, obs
                )
                return (env_states, ctrl_states, obs), u[0, 0]

            (env_states, ctrl_states, obs), u_trace = jax.lax.scan(
                body, (env_states, ctrl_states, obs), None, length=n, unroll=unroll
            )
            return env_states, ctrl_states, obs, u_trace

        window = jax.jit(fused_window, static_argnames="n")

    step = jax.jit(closed_loop_step)

    _progress("building initial state")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    env_states, obs = jax.vmap(lambda k: env_reset_fn(env_p, k))(keys)
    ctrl_states = jax.vmap(
        lambda _: mpc_mod.init_state(horizon, model.nx, model.nu)
    )(jnp.arange(B))

    # Warm-up: compile + two steps (past the cold-start solve into the
    # warm-started tightening-active regime).
    _progress("compiling closed_loop_step")
    for _ in range(2):
        env_states, ctrl_states, obs, u = step(ctrl.consts, gp, env_states, ctrl_states, obs)
    jax.block_until_ready(u)
    _progress("warmup done; timing window starts")

    if fused:
        # warm the scan program too, then time one fused window
        env_states, ctrl_states, obs, _ = window(
            ctrl.consts, gp, env_states, ctrl_states, obs, n_timed_steps
        )
        jax.block_until_ready(obs)
        t0 = time.perf_counter()
        env_states, ctrl_states, obs, u_trace = window(
            ctrl.consts, gp, env_states, ctrl_states, obs, n_timed_steps
        )
        jax.block_until_ready(u_trace)
        dt_total = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        for _ in range(n_timed_steps):
            env_states, ctrl_states, obs, u = step(ctrl.consts, gp, env_states, ctrl_states, obs)
        jax.block_until_ready(u)
        dt_total = time.perf_counter() - t0
    _progress(f"timing window done ({dt_total:.3f}s); printing result")

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "gpmpc_solves_per_sec_1chip"
        + ("" if bench_model == "quadrotor" else f"_{bench_model}"),
        "value": B * n_timed_steps / dt_total,
        "unit": "solves/s",
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
