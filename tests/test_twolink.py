"""Third model family: two-link arm through the generic MPC stack, plus the
Levenberg-Marquardt SQP damping it motivated (SqpConfig.lm_reg,
≙ acados ocp.solver_options.levenberg_marquardt)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmpc_tpu.control.mpc import MPC
from gpmpc_tpu.envs import twolink_env
from gpmpc_tpu.models import twolink
from gpmpc_tpu.models.residual import TWOLINK_SPEC

Q = [20.0, 20.0, 0.5, 0.5]
R = [0.1, 0.1]


def test_twolink_spec_consistency():
    s = TWOLINK_SPEC
    assert (s.num_gps, s.n_unc, s.z_dim, s.gp_input_dim) == (2, 2, 6, 6)
    assert s.uncertain_dim == (2, 3)
    z = jnp.asarray([0.1, 0.2, -0.3, 0.4, 0.5, -0.6])
    np.testing.assert_allclose(
        np.asarray(s.mean_rows(jnp.asarray([1.0, -2.0]), z)), [1.0, -2.0]
    )
    np.testing.assert_allclose(np.asarray(s.var_factors(z)), np.eye(2), atol=1e-8)
    # torque features are scaled into O(1)
    x = jnp.asarray([0.1, 0.2, 0.3, 0.4])
    u = jnp.asarray([10.0, -10.0])
    zin = np.asarray(s.gp_input(x, u))
    np.testing.assert_allclose(zin[4:], [1.0, -1.0])


def test_twolink_dynamics_structure():
    """Closed-form 2x2 M(q) solve matches solving M ddq = rhs directly, and
    gravity_torques holds the arm static."""
    p = twolink.TwoLinkParams()
    x = jnp.asarray([-1.2, 0.9, 0.4, -0.3])
    u = jnp.asarray([3.0, 1.5])
    f = twolink.continuous_dynamics(x, u, p)
    m11, m12, m22, g1, g2, h = twolink._mass_gravity(p, x[0], x[1])
    M = jnp.asarray([[m11, m12], [m12, m22]])
    c = jnp.asarray([-h * x[3] * (2 * x[2] + x[3]), h * x[2] ** 2])
    rhs = u - c - jnp.asarray([g1, g2])
    ddq = jnp.linalg.solve(M, rhs)
    np.testing.assert_allclose(np.asarray(f[2:]), np.asarray(ddq), rtol=1e-5)
    # static equilibrium: zero velocity + gravity-comp torque -> zero accel
    xq = jnp.asarray([-1.0, 0.5, 0.0, 0.0])
    ug = twolink.gravity_torques(xq[0], xq[1], p)
    f0 = twolink.continuous_dynamics(xq, ug, p)
    np.testing.assert_allclose(np.asarray(f0), 0.0, atol=1e-5)


def test_twolink_nominal_mpc_tracks_ideal_plant():
    """Nominal MPC on the ideal plant: the solver stack is (nx=4, nu=2)-generic."""
    env = twolink_env.TwoLinkTrackEnv(twolink_env.EnvParams.ideal())
    model = twolink.symbolic_twolink(dt=0.02)
    ctrl = MPC(model, env.trajectory, horizon=20, q_mpc=Q, r_mpc=[0.02, 0.02],
               sqp_iters=5, qp_iters=8,
               bounds=(twolink.state_bounds(), twolink.input_bounds()))
    obs, _ = env.reset(seed=0)
    ctrl.reset()
    errs = []
    for _ in range(120):
        u = ctrl.select_action(obs)
        obs, r, term, _, _ = env.step(u)
        assert not term
        errs.append(float(-r))
    # settles to tight tracking after the init-noise transient (measured 3e-4)
    assert np.mean(errs[-30:]) < 2e-3, np.mean(errs[-30:])


def test_twolink_mismatch_visible_in_targets():
    """The default plant's structural mismatch must be visible in the spec's
    residual targets (else the learning test is vacuous)."""
    env = twolink_env.TwoLinkTrackEnv(twolink_env.EnvParams.default())
    model = twolink.symbolic_twolink(dt=0.02)
    traj = np.asarray(env.trajectory)
    x = jnp.asarray(traj[:40], jnp.float32)
    u = jnp.asarray(
        np.stack([np.asarray(twolink.gravity_torques(r[0], r[1], model.params))
                  for r in traj[:40]]), jnp.float32)
    # one true-plant step from each trajectory point
    import functools
    step = functools.partial(twolink_env.env_step, env.p)
    states = jax.vmap(lambda xx: twolink_env.EnvState(
        x=xx, t=jnp.asarray(0, jnp.int32), rng=jax.random.PRNGKey(0)))(x)
    _, x_next, *_ = jax.vmap(step)(states, u)
    z, y = TWOLINK_SPEC.make_targets(model, x, u, x_next)
    assert z.shape == (40, 6) and y.shape == (40, 2)
    assert float(jnp.max(jnp.abs(jnp.mean(y, axis=0)))) > 2.0


def test_lm_reg_damps_without_moving_fixed_point():
    """SqpConfig.lm_reg shrinks the first full step (Hessian-only damping) and
    leaves the converged solution essentially unchanged on a benign problem."""
    from gpmpc_tpu.ops.sqp import OcpBounds, OcpCost, SqpConfig, sqp_solve

    model = twolink.symbolic_twolink(dt=0.02)
    env = twolink_env.TwoLinkTrackEnv(twolink_env.EnvParams.ideal())
    T, nx, nu = 10, 4, 2
    traj = jnp.asarray(np.asarray(env.trajectory)[: T + 1], jnp.float32)
    # pin f32: under the suite's x64 flag an unpinned literal array is f64,
    # and the SQP carry must be dtype-consistent (production pins f32)
    x0 = traj[0] + jnp.asarray([0.05, -0.04, 0.1, -0.1], jnp.float32)
    cost = OcpCost(
        xref=traj, uref=jnp.tile(model.u_eq[None], (T, 1)),
        Q=jnp.diag(jnp.asarray(Q, jnp.float32)),
        R=jnp.diag(jnp.asarray(R, jnp.float32)),
        Qe=jnp.diag(jnp.asarray(Q, jnp.float32)),
        scale=jnp.ones(T + 1, jnp.float32),
    )
    lo, hi = twolink.state_bounds()
    lu, uu = twolink.input_bounds()
    bounds = OcpBounds(
        lx=jnp.tile(lo[None], (T + 1, 1)), ux=jnp.tile(hi[None], (T + 1, 1)),
        lu=jnp.tile(lu[None], (T, 1)), uu=jnp.tile(uu[None], (T, 1)),
    )
    X0 = jnp.tile(x0[None], (T + 1, 1))
    U0 = jnp.tile(model.u_eq[None], (T, 1))

    def solve(lm, iters):
        cfg = SqpConfig(sqp_iters=iters, qp_iters=10, lm_reg=lm, early_exit=False)
        return sqp_solve(model.fd_func, cost, bounds, x0, X0, U0, cfg)

    s_plain_1 = solve(0.0, 1)
    s_lm_1 = solve(2.0, 1)
    assert float(s_lm_1.step_norm) < float(s_plain_1.step_norm)

    # converged solutions agree (LM contracts more slowly, so give it room;
    # torque scale here is ~4-7 Nm)
    s_plain = solve(0.0, 25)
    s_lm = solve(0.5, 25)
    np.testing.assert_allclose(
        np.asarray(s_lm.U), np.asarray(s_plain.U), atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(s_lm.X), np.asarray(s_plain.X), atol=1e-2
    )


def test_twolink_batched_episode_generic_runner():
    """The generic episode runner accepts the third family via env_mod=
    (domain-randomized plants included)."""
    import jax
    from gpmpc_tpu.control.gpmpc import GPMPC
    from gpmpc_tpu.parallel.batch import batched_episode

    env = twolink_env.TwoLinkTrackEnv(twolink_env.EnvParams.default())
    model = twolink.symbolic_twolink(dt=0.02)
    ctrl = GPMPC(
        model, env.trajectory, None, horizon=6, q_mpc=Q, r_mpc=R,
        sparse_gp=True, max_gp_samples=8, seed=0, max_gp_points=32,
        sqp_iters=3, qp_iters=5, lm_reg=0.5,
        bounds=(twolink.state_bounds(), twolink.input_bounds()),
    )
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    res = batched_episode(
        model, ctrl.cfg, env.p, ctrl.consts, ctrl.gp_model, keys, n_steps=4,
        use_gp=True, param_scale=0.05, env_mod=twolink_env,
    )
    assert res.obs.shape[:2] == (3, 5) and res.obs.shape[2] == 4
    assert np.all(np.isfinite(np.asarray(res.obs)))
    assert np.all(np.isfinite(np.asarray(res.actions)))
