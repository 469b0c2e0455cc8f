"""Shared helpers for benchmarks and entry points.

Consolidates the reference prior-parameter dict (single source of truth:
models/quadrotor.PRIOR_PARAMS ≙ scripts/gp_mpc_config.yaml:9-17 of the reference),
the synthetic residual datasets + trained GpModels, and `build_problem`, the
closed-loop problem of one plant family that bench.py, chip_smoke.py and the
GPU tests run.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.models.quadrotor import PRIOR_PARAMS

Q_MPC = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
R_MPC = [3, 3, 3, 0.1]


def reference_prior_dict() -> dict:
    """The reference config's prior-parameter dict (gp_mpc_config.yaml:9-17)."""
    return dict(zip("abcdefhl", PRIOR_PARAMS))


def synthetic_residual_dataset(n: int = 60, seed: int = 0):
    """A plausible GP residual dataset at the reference's scale: a thrust-map
    deficit of ~4 m/s^2 plus small attitude-rate residuals (matches what the
    learning loop actually produces; see preprocess_data)."""
    rng = np.random.default_rng(seed)
    x7 = np.zeros((n, 7), np.float32)
    x7[:, 0] = rng.uniform(0.2, 0.5, n)  # thrust command
    x7[:, 1:] = rng.normal(0, 0.2, (n, 6))
    y3 = np.stack(
        [
            4.0 + 0.5 * np.sin(5 * x7[:, 0]) + 0.01 * rng.normal(size=n),
            0.1 * x7[:, 1] + 0.01 * rng.normal(size=n),
            0.1 * x7[:, 4] + 0.01 * rng.normal(size=n),
        ],
        axis=1,
    ).astype(np.float32)
    return x7, y3


def synthetic_gp_model(
    max_points: int = 128,
    max_inducing: int = 40,
    n_data: int = 60,
    n_train: int = 30,
    seed: int = 0,
    ard: bool = False,
):
    """Train a GpModel on the synthetic dataset (jitted; cached per shapes)."""
    from gpmpc_tpu.control.gpmpc import pack_training_data, train_gp_models

    x7, y3 = synthetic_residual_dataset(n_data, seed)
    data = pack_training_data(jnp.asarray(x7), jnp.asarray(y3), max_points)
    fit = jax.jit(
        lambda d, k: train_gp_models(
            d, k, sparse=True, max_inducing=max_inducing, n_train=n_train, lr=0.05,
            ard=ard,
        )
    )
    return fit(data, jax.random.PRNGKey(seed))


def synthetic_cartpole_gp_model(
    max_points: int = 128,
    max_inducing: int = 40,
    n_data: int = 60,
    n_train: int = 30,
    seed: int = 0,
):
    """Cartpole GP ensemble (G=2, D=3) on synthetic acceleration residuals —
    the cartpole analogue of `synthetic_gp_model`, for family-generic benches."""
    from gpmpc_tpu.control.gpmpc import pack_training_data, train_gp_models
    from gpmpc_tpu.models.residual import CARTPOLE_SPEC

    rng = np.random.default_rng(seed)
    xz = np.zeros((n_data, 4), np.float32)  # z = [x_dot, theta, theta_dot, F]
    xz[:, 0] = rng.normal(0, 0.5, n_data)
    xz[:, 1] = rng.normal(0, 0.2, n_data)
    xz[:, 2] = rng.normal(0, 0.5, n_data)
    xz[:, 3] = rng.uniform(-6.0, 6.0, n_data)
    y = np.stack(
        [
            -0.4 * xz[:, 0] + 0.12 * xz[:, 3] + 0.01 * rng.normal(size=n_data),
            -0.5 * xz[:, 2] - 0.3 * xz[:, 1] + 0.01 * rng.normal(size=n_data),
        ],
        axis=1,
    ).astype(np.float32)
    data = pack_training_data(jnp.asarray(xz), jnp.asarray(y), max_points, CARTPOLE_SPEC)
    fit = jax.jit(
        lambda d, k: train_gp_models(
            d, k, sparse=True, max_inducing=max_inducing, n_train=n_train, lr=0.05
        )
    )
    return fit(data, jax.random.PRNGKey(seed))


def synthetic_twolink_gp_model(
    max_points: int = 128,
    max_inducing: int = 40,
    n_data: int = 60,
    n_train: int = 30,
    seed: int = 0,
):
    """Two-link GP ensemble (G=2, D=6) on synthetic acceleration residuals."""
    from gpmpc_tpu.control.gpmpc import pack_training_data, train_gp_models
    from gpmpc_tpu.models.residual import TWOLINK_SPEC

    rng = np.random.default_rng(seed)
    xz = np.zeros((n_data, 6), np.float32)  # z = [q1, q2, dq1, dq2, t1/10, t2/10]
    xz[:, 0] = rng.uniform(-2.0, 0.0, n_data)
    xz[:, 1] = rng.uniform(0.0, 1.5, n_data)
    xz[:, 2:4] = rng.normal(0, 0.5, (n_data, 2))
    xz[:, 4:] = rng.uniform(-1.0, 1.0, (n_data, 2))
    y = np.stack(
        [
            1.5 + 0.4 * np.sin(xz[:, 1]) + 0.8 * xz[:, 4] + 0.01 * rng.normal(size=n_data),
            -9.0 - 0.5 * xz[:, 2] + 0.6 * xz[:, 5] + 0.01 * rng.normal(size=n_data),
        ],
        axis=1,
    ).astype(np.float32)
    data = pack_training_data(jnp.asarray(xz), jnp.asarray(y), max_points, TWOLINK_SPEC)
    fit = jax.jit(
        lambda d, k: train_gp_models(
            d, k, sparse=True, max_inducing=max_inducing, n_train=n_train, lr=0.05
        )
    )
    return fit(data, jax.random.PRNGKey(seed))


class Problem(NamedTuple):
    """A closed-loop GP-MPC problem: controller, trained GP and plant."""

    env: object
    model: object
    ctrl: object  # control/gpmpc.py::GPMPC (carries cfg and consts)
    gp: object
    env_params: object
    env_step: Callable
    env_reset: Callable


# The bench numerical settings: sqp 6 / qp 10, Mehrotra, adaptive IP exit at
# 1e-6 (acados's own default tolerances; the reference sets only iteration
# caps, /root/reference/gpmpc/mpc.py:113-120).
BENCH_SQP = dict(sqp_iters=6, qp_iters=10)
BENCH_QP_TOL = 1e-6


def build_problem(
    family: str = "quadrotor",
    horizon: int = 25,
    gp_points: int = 128,
    gp_inducing: int = 40,
    gp_data: int | None = None,
    n_train: int = 50,
) -> Problem:
    """One family's closed-loop problem at the given size. The defaults are
    the reference configuration: quadrotor, T=25, 3 GPs with 40 FITC inducing
    points over a 128-point padded GP buffer. The controller's cfg carries the
    bench numerical settings (BENCH_SQP, Mehrotra, BENCH_QP_TOL)."""
    from gpmpc_tpu.control.gpmpc import GPMPC

    gp_data = min(gp_points if gp_data is None else gp_data, gp_points)
    gp_kw = dict(
        max_points=gp_points, max_inducing=gp_inducing, n_data=gp_data, n_train=n_train
    )
    ctrl_kw = dict(
        horizon=horizon, sparse_gp=True, prob=0.95, max_gp_samples=gp_inducing,
        seed=1, max_gp_points=gp_points, **BENCH_SQP,
    )
    if family == "twolink":
        from gpmpc_tpu.envs import twolink_env as env_mod
        from gpmpc_tpu.models import twolink as twolink_mod

        env = env_mod.TwoLinkTrackEnv(env_mod.EnvParams.default())
        model = twolink_mod.symbolic_twolink(dt=0.02)
        ctrl = GPMPC(
            model, env.trajectory, None, q_mpc=[20.0, 20.0, 0.5, 0.5],
            r_mpc=[0.1, 0.1], lm_reg=0.5,
            bounds=(twolink_mod.state_bounds(), twolink_mod.input_bounds()), **ctrl_kw,
        )
        gp = synthetic_twolink_gp_model(**gp_kw)
    elif family == "cartpole":
        from gpmpc_tpu.envs import cartpole_env as env_mod
        from gpmpc_tpu.models import cartpole as cartpole_mod

        env = env_mod.CartpoleTrackEnv(env_mod.EnvParams.default())
        model = cartpole_mod.symbolic_cartpole(dt=0.02)
        ctrl = GPMPC(
            model, env.trajectory, None, q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
            bounds=(cartpole_mod.state_bounds(), cartpole_mod.input_bounds()), **ctrl_kw,
        )
        gp = synthetic_cartpole_gp_model(**gp_kw)
    elif family == "quadrotor":
        from gpmpc_tpu.envs import drone as env_mod
        from gpmpc_tpu.models.symbolic import symbolic_attitude

        prior_params = reference_prior_dict()
        env = env_mod.DroneFigureEightEnv()
        model = symbolic_attitude(dt=0.02, params=prior_params)
        ctrl = GPMPC(
            model, env.trajectory, prior_params, q_mpc=Q_MPC, r_mpc=R_MPC, **ctrl_kw
        )
        # Train the GPs on a synthetic residual dataset at the requested scale
        # so the problem exercises the real augmented dynamics + tightening.
        gp = synthetic_gp_model(**gp_kw)
    else:
        raise ValueError(f"unknown family {family!r}")
    ctrl.cfg = ctrl.cfg._replace(qp_mehrotra=True, qp_tol=BENCH_QP_TOL)
    return Problem(env, model, ctrl, gp, env.p, env_mod.env_step, env_mod.env_reset)
