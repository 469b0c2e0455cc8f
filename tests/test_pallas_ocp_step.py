"""Controller-level parity: the batched GP-MPC step through the Pallas QP
kernel (interpret mode) against the vmapped XLA step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

def test_batched_lanes_step_matches_xla_step():
    """Full GP-MPC step parity: lanes backend vs vmapped XLA backend."""
    from gpmpc_tpu.control import gpmpc as gpmpc_mod
    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv, EnvParams
    from gpmpc_tpu.models.symbolic import symbolic_attitude

    prior = {"a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
             "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653}
    env = DroneFigureEightEnv(EnvParams.default()._replace(n_steps=64, traj_amplitude=0.1))
    model = symbolic_attitude(dt=0.02, params=prior)
    q = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
    r = [3, 3, 3, 0.1]
    ctrl = GPMPC(model, env.trajectory, prior, horizon=6, q_mpc=q, r_mpc=r,
                 sparse_gp=True, max_gp_samples=8, seed=0, max_gp_points=32,
                 sqp_iters=2, qp_iters=6)
    rng = np.random.default_rng(0)
    ctrl.train_gp(rng.normal(0, 0.3, (16, 7)).astype(np.float32),
                  rng.normal(0, 0.3, (16, 3)).astype(np.float32), lr=0.05, iterations=10)

    Bn = 4
    obs = jnp.asarray(
        np.asarray(env.trajectory[0])[None] + 0.01 * rng.normal(size=(Bn, 12)), jnp.float32
    )
    states = jax.vmap(lambda _: mpc_mod.init_state(6, 12, 4))(jnp.arange(Bn))

    u_x, st_x, _ = jax.vmap(
        lambda s, o: gpmpc_mod.select_action(model, ctrl.cfg, ctrl.consts, ctrl.gp_model, s, o),
    )(states, obs)
    u_l, st_l, _ = gpmpc_mod.batched_select_action_lanes(
        model, ctrl.cfg, ctrl.consts, ctrl.gp_model, states, obs, interpret=True
    )
    np.testing.assert_allclose(np.asarray(u_l), np.asarray(u_x), atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(st_l.X_warm), np.asarray(st_x.X_warm), atol=5e-3
    )

def test_lanes_analytic_jac_matches_jacfwd_path():
    """The analytic-Jacobian linearizer produces the same batched GP-MPC actions
    as the jacfwd path."""
    from gpmpc_tpu.control import gpmpc as gpmpc_mod
    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv, EnvParams
    from gpmpc_tpu.models.symbolic import symbolic_attitude

    prior = {"a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
             "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653}
    env = DroneFigureEightEnv(EnvParams.default()._replace(n_steps=64, traj_amplitude=0.1))
    model = symbolic_attitude(dt=0.02, params=prior)
    ctrl = GPMPC(model, env.trajectory, prior, horizon=6, q_mpc=[8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001],
                 r_mpc=[3, 3, 3, 0.1], sparse_gp=True, max_gp_samples=8, seed=0,
                 max_gp_points=32, sqp_iters=2, qp_iters=6)
    rng = np.random.default_rng(0)
    ctrl.train_gp(rng.normal(0, 0.3, (16, 7)).astype(np.float32),
                  rng.normal(0, 0.3, (16, 3)).astype(np.float32), lr=0.05, iterations=10)

    Bn = 2
    obs = jnp.asarray(
        np.asarray(env.trajectory[0])[None] + 0.01 * rng.normal(size=(Bn, 12)), jnp.float32
    )
    states = jax.vmap(lambda _: mpc_mod.init_state(6, 12, 4))(jnp.arange(Bn))
    u_j, _, _ = gpmpc_mod.batched_select_action_lanes(
        model, ctrl.cfg, ctrl.consts, ctrl.gp_model, states, obs, interpret=True
    )
    cfg_a = ctrl.cfg._replace(analytic_jac=True)
    u_a, _, _ = gpmpc_mod.batched_select_action_lanes(
        model, cfg_a, ctrl.consts, ctrl.gp_model, states, obs, interpret=True
    )
    np.testing.assert_allclose(np.asarray(u_a), np.asarray(u_j), atol=5e-5)

@pytest.mark.slow
def test_lanes_step_T52_matches_xla():
    """A longer horizon runs the same kernel body and still matches the
    vmapped XLA step."""
    from gpmpc_tpu.control import gpmpc as gpmpc_mod
    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv, EnvParams
    from gpmpc_tpu.models.symbolic import symbolic_attitude

    prior = {"a": 12.1432, "b": 1.8118, "c": -72.08, "d": -7.5755,
             "e": 39.8653, "f": -72.08, "h": -7.5755, "l": 39.8653}
    env = DroneFigureEightEnv(EnvParams.default()._replace(n_steps=64, traj_amplitude=0.1))
    model = symbolic_attitude(dt=0.02, params=prior)
    q = [8, 0.1, 8, 0.1, 8, 0.1, 0.5, 0.5, 0.5, 0.001, 0.001, 0.001]
    r = [3, 3, 3, 0.1]
    horizon = 52
    ctrl = GPMPC(model, env.trajectory, prior, horizon=horizon, q_mpc=q, r_mpc=r,
                 sparse_gp=True, max_gp_samples=8, seed=0, max_gp_points=32,
                 sqp_iters=2, qp_iters=6)
    rng = np.random.default_rng(0)
    ctrl.train_gp(rng.normal(0, 0.3, (16, 7)).astype(np.float32),
                  rng.normal(0, 0.3, (16, 3)).astype(np.float32), lr=0.05, iterations=10)

    Bn = 2
    obs = jnp.asarray(
        np.asarray(env.trajectory[0])[None] + 0.01 * rng.normal(size=(Bn, 12)), jnp.float32
    )
    states = jax.vmap(lambda _: mpc_mod.init_state(horizon, 12, 4))(jnp.arange(Bn))

    u_x, st_x, _ = jax.vmap(
        lambda s, o: gpmpc_mod.select_action(model, ctrl.cfg, ctrl.consts, ctrl.gp_model, s, o),
    )(states, obs)
    u_l, st_l, _ = gpmpc_mod.batched_select_action_lanes(
        model, ctrl.cfg, ctrl.consts, ctrl.gp_model, states, obs, interpret=True
    )
    np.testing.assert_allclose(np.asarray(u_l), np.asarray(u_x), atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(st_l.X_warm), np.asarray(st_x.X_warm), atol=5e-3
    )


def test_lanes_soft_step_matches_xla_soft_step():
    """Controller-level parity with soft constraints on both backends."""
    from functools import partial

    from gpmpc_tpu.control import gpmpc as gpmpc_mod
    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.envs.drone import DroneFigureEightEnv
    from gpmpc_tpu.models.symbolic import symbolic_attitude
    from gpmpc_tpu.utils.benchkit import Q_MPC, R_MPC, reference_prior_dict

    B = 4
    env = DroneFigureEightEnv()
    model = symbolic_attitude(dt=0.02, params=reference_prior_dict())
    ctrl = GPMPC(
        model, env.trajectory, reference_prior_dict(), horizon=5,
        q_mpc=Q_MPC, r_mpc=R_MPC, sparse_gp=False, seed=0, max_gp_points=16,
        sqp_iters=2, qp_iters=8, soft_constraints=50.0,
    )
    # Large (but not box-crossing) variance so the soft path is exercised.
    gp = ctrl.gp_model._replace(
        hypers=ctrl.gp_model.hypers._replace(
            raw_outputscale=jnp.full((3,), 30.0, jnp.float32)
        ),
        trained=jnp.asarray(True),
    )
    rng = np.random.default_rng(0)
    obs = jnp.asarray(
        env.trajectory[:B] + 0.01 * rng.normal(size=(B, 12)), jnp.float32
    )
    states = jax.vmap(lambda i: mpc_mod.init_state(5, 12, 4)._replace(
        traj_step=jnp.asarray(1, jnp.int32),
        X_warm=jnp.tile(obs[i][None], (6, 1)),
    ))(jnp.arange(B))
    u_lanes, _, info_lanes = gpmpc_mod.batched_select_action_lanes(
        model, ctrl.cfg, ctrl.consts, gp, states, obs, interpret=True
    )
    step = partial(gpmpc_mod.select_action, model, ctrl.cfg)
    u_xla, _, info_xla = jax.vmap(lambda s, o: step(ctrl.consts, gp, s, o))(states, obs)
    np.testing.assert_allclose(np.asarray(u_lanes), np.asarray(u_xla), atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(info_lanes.soft_viol), np.asarray(info_xla.soft_viol), atol=2e-3
    )
