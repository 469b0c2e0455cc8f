"""Per-model residual-GP structure: the `ResidualSpec`.

The reference hardwires the quadrotor's residual-learning structure into its
controller: which (x, u) components feed the GPs (gp_idx,
/root/reference/gpmpc/gpmpc.py:59), which state rows receive uncertainty (the
Bd column selection at gpmpc.py:68-69), how the scalar thrust-residual GP is
rotated into world axes (gpmpc.py:193-197), and how rollout transitions become
residual training targets (preprocess_data, gpmpc.py:113-151). A framework
should own that structure as *data carried by the model family*, not as
controller code — this module is that data.

A `ResidualSpec` answers five questions for one model family:

  1. `gp_input(x, u) -> z`        — which features feed the GP ensemble,
  2. `gp_idx`                     — which z-columns each individual GP sees,
  3. `mean_rows(preds, z)`        — how the GP means inject into f(x, u)
                                    (the rows listed in `uncertain_dim`),
  4. `var_factors(z)`             — the linear map F(z) taking per-GP
                                    variances to the disturbance-covariance
                                    diagonal on the uncertain rows
                                    (≙ the world-axis rotation factors at
                                    gpmpc.py:447-457; identity for models
                                    whose GPs act directly on state rows),
  5. `make_targets(model, x, u, x_next)` — transition preprocessing into
                                    (GP inputs, residual targets).

Everything in `control/gpmpc.py` is written against this contract; the
quadrotor and cartpole instances below are the two proofs (both run the full
learn loop through the identical code path — tests/test_learning_loop.py).

Specs are module-level singletons: controllers close over them inside `jit`,
so a stable identity avoids spurious retraces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp

from gpmpc_tpu.models import cartpole as cartpole_mod
from gpmpc_tpu.models import quadrotor


@dataclass(frozen=True)
class ResidualSpec:
    """Residual-GP structure of one model family (static; carried by
    `SymbolicModel.residual_spec` and closed over by jitted controllers)."""

    name: str
    # Width of the full GP feature vector z produced by `gp_input`.
    z_dim: int
    # Per-GP column selection into z (≙ gp_idx, gpmpc.py:59). len() == number
    # of GPs; slices shorter than the longest are zero-padded.
    gp_idx: tuple[tuple[int, ...], ...]
    # State rows of dx/dt that receive residual mean + uncertainty — the
    # columns of the injection matrix Bd = I[:, uncertain_dim]
    # (≙ gpmpc.py:68-69).
    uncertain_dim: tuple[int, ...]
    # (x (..., nx), u (..., nu)) -> z (..., z_dim).
    gp_input: Callable[[jax.Array, jax.Array], jax.Array] = field(repr=False)
    # (preds (num_gps,), z (z_dim,)) -> residual values on the uncertain rows
    # (n_unc,) (≙ the rotation at gpmpc.py:193-197).
    mean_rows: Callable[[jax.Array, jax.Array], jax.Array] = field(repr=False)
    # z (..., z_dim) -> F (..., n_unc, num_gps): disturbance-diagonal factors;
    # diag = F @ (gp_variances + gp_noise) (≙ gpmpc.py:447-469).
    var_factors: Callable[[jax.Array], jax.Array] = field(repr=False)
    # (model, x (N, nx), u (N, nu), x_next (N, nx)) -> (z (N, z_dim),
    # y (N, num_gps)) residual training data (≙ preprocess_data,
    # gpmpc.py:113-151).
    make_targets: Callable[..., tuple[jax.Array, jax.Array]] = field(repr=False)

    @property
    def num_gps(self) -> int:
        return len(self.gp_idx)

    @property
    def n_unc(self) -> int:
        return len(self.uncertain_dim)

    @property
    def gp_input_dim(self) -> int:
        """Padded per-GP slice width (the widest gp_idx entry)."""
        return max(len(idx) for idx in self.gp_idx)


# ---------------------------------------------------------------------------
# Quadrotor (the reference's hardwired structure, as data)
# ---------------------------------------------------------------------------


def _quad_gp_input(x: jax.Array, u: jax.Array) -> jax.Array:
    """z = [thrust, phi, dphi, phi_cmd, theta, dtheta, theta_cmd]
    (≙ the idx_T/idx_R/idx_P selection at gpmpc.py:173)."""
    return jnp.stack(
        [
            u[..., 0],
            x[..., quadrotor.IDX_PHI], x[..., quadrotor.IDX_DPHI], u[..., 1],
            x[..., quadrotor.IDX_THETA], x[..., quadrotor.IDX_DTHETA], u[..., 2],
        ],
        axis=-1,
    )


def _quad_mean_rows(preds: jax.Array, z: jax.Array) -> jax.Array:
    """Thrust-magnitude GP rotated into world axes by
    (cos phi sin theta, -sin phi, cos phi cos theta) plus the phi/theta
    rate-residual rows (≙ gpmpc.py:193-197)."""
    T_pred, R_pred, P_pred = preds[0], preds[1], preds[2]
    phi, theta = z[1], z[4]
    return jnp.stack(
        [
            T_pred * jnp.cos(phi) * jnp.sin(theta),
            T_pred * (-jnp.sin(phi)),
            T_pred * jnp.cos(phi) * jnp.cos(theta),
            R_pred,
            P_pred,
        ]
    )


def _quad_var_factors(z: jax.Array) -> jax.Array:
    """F (..., 5, 3): the acceleration GP's variance enters the world-frame
    rows through the squared rotation factors; the rate GPs map one-to-one.
    Uses the mathematically consistent (cos phi sin theta)^2 on the x row —
    the reference's missing cosine square (gpmpc.py:448) is a documented
    quirk deliberately not copied (control/gpmpc.py module docstring)."""
    phi, theta = z[..., 1], z[..., 4]
    f_ax = (jnp.cos(phi) * jnp.sin(theta)) ** 2
    f_ay = jnp.sin(phi) ** 2
    f_az = (jnp.cos(phi) * jnp.cos(theta)) ** 2
    zero = jnp.zeros_like(f_ax)
    one = jnp.ones_like(f_ax)
    rows = [
        jnp.stack([f_ax, zero, zero], axis=-1),
        jnp.stack([f_ay, zero, zero], axis=-1),
        jnp.stack([f_az, zero, zero], axis=-1),
        jnp.stack([zero, one, zero], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def _quad_make_targets(model, x, u, x_next):
    """≙ preprocess_data (gpmpc.py:113-151) with the thrust map a*T + b taken
    from the model's own prior parameters. Delegates to the quadrotor-compat
    function in control/gpmpc.py (kept as the reference-shaped public API)."""
    from gpmpc_tpu.control.gpmpc import preprocess_data_jnp

    p = model.params
    return preprocess_data_jnp(model, float(p.a), float(p.b), x, u, x_next)


QUADROTOR_SPEC = ResidualSpec(
    name="quadrotor",
    z_dim=7,
    gp_idx=((0,), (1, 2, 3), (4, 5, 6)),
    uncertain_dim=(1, 3, 5, 9, 10),
    gp_input=_quad_gp_input,
    mean_rows=_quad_mean_rows,
    var_factors=_quad_var_factors,
    make_targets=_quad_make_targets,
)


# ---------------------------------------------------------------------------
# Cartpole (second family: proves the learning loop is model-agnostic)
# ---------------------------------------------------------------------------


def _cart_gp_input(x: jax.Array, u: jax.Array) -> jax.Array:
    """z = [x_dot, theta, theta_dot, force]: the features the cartpole's
    unmodeled effects (friction, mass/length error, actuation gain) act
    through."""
    return jnp.stack(
        [
            x[..., cartpole_mod.IDX_DX],
            x[..., cartpole_mod.IDX_THETA],
            x[..., cartpole_mod.IDX_DTHETA],
            u[..., 0],
        ],
        axis=-1,
    )


def _cart_mean_rows(preds: jax.Array, z: jax.Array) -> jax.Array:
    """The two GPs act directly on the acceleration rows — no rotation."""
    return preds


def _cart_var_factors(z: jax.Array) -> jax.Array:
    """Identity map: GP k's variance lands on uncertain row k."""
    eye = jnp.eye(2, dtype=z.dtype)
    return jnp.broadcast_to(eye, z.shape[:-1] + (2, 2))


def _cart_make_targets(model, x, u, x_next):
    """Residual targets on the two acceleration rows: finite-difference state
    derivative minus the prior model's prediction (same recipe as the
    quadrotor's rate rows, gpmpc.py:140-150)."""
    dt = model.dt
    x_dot = (x_next - x) / dt
    f_prior = jax.vmap(model.fc_func)(x, u)
    y = jnp.stack(
        [
            x_dot[:, cartpole_mod.IDX_DX] - f_prior[:, cartpole_mod.IDX_DX],
            x_dot[:, cartpole_mod.IDX_DTHETA] - f_prior[:, cartpole_mod.IDX_DTHETA],
        ],
        axis=1,
    )
    return _cart_gp_input(x, u), y


CARTPOLE_SPEC = ResidualSpec(
    name="cartpole",
    z_dim=4,
    # GP0 (cart acceleration residual): cart friction + gain error act through
    # (x_dot, theta_dot, force); GP1 (pole acceleration residual): pivot
    # friction + mass/length error act through (theta, theta_dot, force).
    gp_idx=((0, 2, 3), (1, 2, 3)),
    uncertain_dim=(cartpole_mod.IDX_DX, cartpole_mod.IDX_DTHETA),
    gp_input=_cart_gp_input,
    mean_rows=_cart_mean_rows,
    var_factors=_cart_var_factors,
    make_targets=_cart_make_targets,
)


# ---------------------------------------------------------------------------
# Two-link arm (third family: N=3 keeps the spec layer honest; D=6 GP inputs
# exercise the non-3-dim dispatch of the variance backends)
# ---------------------------------------------------------------------------


# Torque features are scaled into the O(1) range of the angle/rate features
# (the input box is +-20 Nm): with mixed raw scales the fitted lengthscales
# collapse along the torque axes and the GP mean surface becomes rugged enough
# to destabilize the Gauss-Newton SQP (measured: full-step SQP chattered on
# the rails with raw torques; scaled features converge).
_TWOLINK_TAU_SCALE = 0.1


def _twolink_gp_input(x: jax.Array, u: jax.Array) -> jax.Array:
    """z = [q1, q2, dq1, dq2, tau1/10, tau2/10]: payload gravity/inertia
    mismatch acts through the posture (q1, q2) and the torques; joint friction
    through the joint rates."""
    from gpmpc_tpu.models import twolink as twolink_mod

    return jnp.concatenate(
        [
            jnp.stack(
                [
                    x[..., twolink_mod.IDX_Q1],
                    x[..., twolink_mod.IDX_Q2],
                    x[..., twolink_mod.IDX_DQ1],
                    x[..., twolink_mod.IDX_DQ2],
                ],
                axis=-1,
            ),
            _TWOLINK_TAU_SCALE * u[..., :2],
        ],
        axis=-1,
    )


def _twolink_mean_rows(preds: jax.Array, z: jax.Array) -> jax.Array:
    """GPs act directly on the two joint-acceleration rows — no rotation."""
    return preds


def _twolink_var_factors(z: jax.Array) -> jax.Array:
    eye = jnp.eye(2, dtype=z.dtype)
    return jnp.broadcast_to(eye, z.shape[:-1] + (2, 2))


def _twolink_make_targets(model, x, u, x_next):
    """Residual targets on the joint-acceleration rows: finite-difference
    derivative minus the prior (the cartpole recipe at a new family)."""
    from gpmpc_tpu.models import twolink as twolink_mod

    dt = model.dt
    x_dot = (x_next - x) / dt
    f_prior = jax.vmap(model.fc_func)(x, u)
    rows = jnp.asarray([twolink_mod.IDX_DQ1, twolink_mod.IDX_DQ2])
    y = (x_dot - f_prior)[:, rows]
    return _twolink_gp_input(x, u), y


TWOLINK_SPEC = ResidualSpec(
    name="twolink",
    z_dim=6,
    # BOTH GPs see the full feature vector: ddq = M(q)^{-1}(tau - C dq - g)
    # couples every residual row to BOTH torques and BOTH rates through the
    # inertia-matrix off-diagonal (a tip payload changes m12 too), so slicing
    # per-joint features — fine for the cartpole — underfits here off-manifold
    # (measured: per-joint slices made GP-MPC WORSE than the prior; full
    # features + ARD beat it). D=6 also exercises the non-3-dim dispatch of
    # the variance backends.
    gp_idx=((0, 1, 2, 3, 4, 5), (0, 1, 2, 3, 4, 5)),
    uncertain_dim=(2, 3),
    gp_input=_twolink_gp_input,
    mean_rows=_twolink_mean_rows,
    var_factors=_twolink_var_factors,
    make_targets=_twolink_make_targets,
)
