"""ResidualSpec contract (models/residual.py): the per-model data that replaced
the reference's hardwired controller structure must reproduce it exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.models.residual import CARTPOLE_SPEC, QUADROTOR_SPEC


def test_quadrotor_spec_matches_reference_structure():
    """The spec's static fields ARE the reference's constants
    (/root/reference/gpmpc/gpmpc.py:59 gp_idx, :68-69 Bd rows)."""
    s = QUADROTOR_SPEC
    assert s.gp_idx == ((0,), (1, 2, 3), (4, 5, 6))
    assert s.uncertain_dim == (1, 3, 5, 9, 10)
    assert (s.num_gps, s.n_unc, s.z_dim, s.gp_input_dim) == (3, 5, 7, 3)


def test_quadrotor_mean_rows_is_the_world_axis_rotation():
    """mean_rows must be the thrust rotation (cphi*sth, -sphi, cphi*cth) plus
    the rate rows (≙ gpmpc.py:193-197)."""
    phi, theta = 0.3, -0.2
    z = jnp.zeros(7).at[1].set(phi).at[4].set(theta)
    preds = jnp.asarray([2.0, 0.5, -0.7])
    rows = np.asarray(QUADROTOR_SPEC.mean_rows(preds, z))
    cphi, sphi = np.cos(phi), np.sin(phi)
    cth, sth = np.cos(theta), np.sin(theta)
    np.testing.assert_allclose(
        rows, [2.0 * cphi * sth, -2.0 * sphi, 2.0 * cphi * cth, 0.5, -0.7],
        rtol=1e-6,
    )


def test_quadrotor_var_factors_are_squared_rotation():
    """var_factors carries the SQUARED factors (incl. the cos^2 the reference
    drops — documented quirk fix) with identity rows for the rate GPs."""
    phi, theta = 0.25, 0.4
    z = jnp.zeros(7).at[1].set(phi).at[4].set(theta)
    F = np.asarray(QUADROTOR_SPEC.var_factors(z))
    assert F.shape == (5, 3)
    cphi, sphi = np.cos(phi), np.sin(phi)
    cth, sth = np.cos(theta), np.sin(theta)
    np.testing.assert_allclose(F[:, 0], [
        (cphi * sth) ** 2, sphi**2, (cphi * cth) ** 2, 0.0, 0.0], rtol=1e-6)
    np.testing.assert_allclose(F[:, 1], [0, 0, 0, 1, 0], atol=1e-8)
    np.testing.assert_allclose(F[:, 2], [0, 0, 0, 0, 1], atol=1e-8)
    # batched query shape broadcasts
    zb = jnp.tile(z[None], (4, 1))
    assert QUADROTOR_SPEC.var_factors(zb).shape == (4, 5, 3)


def test_quadrotor_make_targets_equals_legacy_preprocess():
    """spec.make_targets == the reference-shaped preprocess_data_jnp with the
    model's own thrust map."""
    from gpmpc_tpu.control.gpmpc import preprocess_data_jnp
    from gpmpc_tpu.models.symbolic import symbolic_attitude

    model = symbolic_attitude(dt=0.02)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 0.2, (9, 12)), jnp.float32)
    u = jnp.asarray(rng.uniform(0.2, 0.5, (9, 4)), jnp.float32)
    xn = x + jnp.asarray(rng.normal(0, 0.01, (9, 12)), jnp.float32)
    zi, yi = QUADROTOR_SPEC.make_targets(model, x, u, xn)
    p = model.params
    zr, yr = preprocess_data_jnp(model, float(p.a), float(p.b), x, u, xn)
    np.testing.assert_array_equal(np.asarray(zi), np.asarray(zr))
    np.testing.assert_array_equal(np.asarray(yi), np.asarray(yr))


def test_cartpole_spec_consistency():
    s = CARTPOLE_SPEC
    assert (s.num_gps, s.n_unc, s.z_dim, s.gp_input_dim) == (2, 2, 4, 3)
    z = jnp.asarray([0.1, 0.2, -0.3, 1.5])
    np.testing.assert_allclose(
        np.asarray(s.mean_rows(jnp.asarray([1.0, -2.0]), z)), [1.0, -2.0]
    )
    np.testing.assert_allclose(np.asarray(s.var_factors(z)), np.eye(2), atol=1e-8)


def test_gp_residual_injects_through_spec():
    """gp_residual == Bd @ mean_rows(GP posterior means) for any spec."""
    from gpmpc_tpu.control.gpmpc import empty_gp_model, gp_residual

    for spec, nx, nu in ((QUADROTOR_SPEC, 12, 4), (CARTPOLE_SPEC, 4, 1)):
        gp = empty_gp_model(8, 8, spec=spec)
        # untrained: zero alpha -> zero residual everywhere
        x = jnp.asarray(np.random.default_rng(1).normal(0, 0.2, nx), jnp.float32)
        u = jnp.asarray(np.random.default_rng(2).normal(0, 0.2, nu), jnp.float32)
        res = np.asarray(gp_residual(gp, x, u, spec))
        assert res.shape == (nx,)
        np.testing.assert_array_equal(res, 0.0)
        # nonzero alpha: residual vanishes exactly OFF the uncertain rows
        gp = gp._replace(
            alpha_s=jnp.ones_like(gp.alpha_s), mask=jnp.ones_like(gp.mask),
            Zs=gp.Zs + 0.1,
        )
        res = np.asarray(gp_residual(gp, x, u, spec))
        off = np.setdiff1d(np.arange(nx), np.asarray(spec.uncertain_dim))
        np.testing.assert_array_equal(res[off], 0.0)
        assert np.any(res[np.asarray(spec.uncertain_dim)] != 0.0)


def test_cartpole_tightening_activates_through_spec():
    """The chance-constraint path consumes CARTPOLE_SPEC's identity
    var_factors: zero tightening before training, positive on the uncertain
    rows (and only there at the first propagation step) after."""
    import jax

    from gpmpc_tpu.control import mpc as mpc_mod
    from gpmpc_tpu.control.gpmpc import GPMPC, propagate_constraint_limits
    from gpmpc_tpu.envs import cartpole_env
    from gpmpc_tpu.models import cartpole

    envp = cartpole_env.EnvParams.default()._replace(n_steps=64, traj_period_steps=300)
    traj = cartpole_env.make_trajectory(envp)
    model = cartpole.symbolic_cartpole(dt=0.02)
    ctrl = GPMPC(
        model, traj, None, horizon=8, q_mpc=[5.0, 0.1, 20.0, 0.5], r_mpc=[0.05],
        sparse_gp=True, max_gp_samples=8, seed=0, max_gp_points=32,
        sqp_iters=2, qp_iters=5,
        bounds=(cartpole.state_bounds(), cartpole.input_bounds()),
    )
    state = mpc_mod.init_state(8, cartpole.NX, cartpole.NU)
    # untrained: variance path finite, and the controller gates tightening off
    t_x, t_u = propagate_constraint_limits(
        ctrl.consts, ctrl.gp_model, state.X_warm, state.U_warm, CARTPOLE_SPEC
    )
    assert np.all(np.isfinite(np.asarray(t_x)))

    rng = np.random.default_rng(0)
    ctrl.train_gp(rng.normal(0, 0.4, (16, 4)).astype(np.float32),
                  rng.normal(0, 0.4, (16, 2)).astype(np.float32),
                  lr=0.05, iterations=20)
    t_x, t_u = jax.jit(
        lambda g, X, U: propagate_constraint_limits(ctrl.consts, g, X, U, CARTPOLE_SPEC)
    )(ctrl.gp_model, state.X_warm, state.U_warm)
    t_x = np.asarray(t_x)
    # stage 1 state tightening: positive exactly on the uncertain rows (the
    # disturbance enters there; positions couple only at later stages)
    assert np.all(t_x[1][list(CARTPOLE_SPEC.uncertain_dim)] > 0.0)
    off = np.setdiff1d(np.arange(cartpole.NX), np.asarray(CARTPOLE_SPEC.uncertain_dim))
    np.testing.assert_allclose(t_x[1][off], 0.0, atol=1e-7)
    # by the horizon end the uncertainty has propagated into the position rows
    assert np.all(t_x[-1] > 0.0)
