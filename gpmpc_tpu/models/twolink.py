"""Two-link planar manipulator model family (third family).

The reference framework is single-model; this family exists to keep the
framework honest at N=3: a robot-arm workload with genuinely different
nonlinear structure from both the quadrotor (which is feedback-linear in the
attitude rows) and the cartpole (single underactuated DOF) — configuration-
dependent inertia coupling M(q), velocity products C(q, dq)dq, and a gravity
field g(q), with nu=2 torques (between the cartpole's 1 and the quadrotor's 4,
so solver shape-genericity keeps being exercised from a new point).

Dynamics: the standard planar 2R manipulator (uniform-rod links),
M(q) ddq + C(q, dq) dq + g(q) = tau, solved closed-form (2x2). State
[q1, q2, dq1, dq2] with q1 measured from the +x axis (q1 = -pi/2 is hanging),
q2 the relative elbow angle; input [tau1, tau2].

The residual-GP structure (TWOLINK_SPEC, models/residual.py) puts one GP on
each joint-acceleration row — the rows where an unmodeled payload, joint
friction, and torque-gain error act (envs/twolink_env.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.models import quadrotor
from gpmpc_tpu.models.symbolic import SymbolicModel

NX = 4
NU = 2
GRAVITY = 9.81

IDX_Q1, IDX_Q2, IDX_DQ1, IDX_DQ2 = 0, 1, 2, 3


class TwoLinkParams(NamedTuple):
    m1: float = 1.0  # kg, link-1 mass (uniform rod)
    m2: float = 1.0  # kg, link-2 mass
    l1: float = 1.0  # m
    l2: float = 1.0  # m


def _mass_gravity(p: TwoLinkParams, q1, q2):
    """M(q) entries and gravity torques for the uniform-rod 2R arm."""
    lc1, lc2 = 0.5 * p.l1, 0.5 * p.l2
    i1, i2 = p.m1 * p.l1**2 / 12.0, p.m2 * p.l2**2 / 12.0
    c2 = jnp.cos(q2)
    m11 = i1 + i2 + p.m1 * lc1**2 + p.m2 * (p.l1**2 + lc2**2 + 2.0 * p.l1 * lc2 * c2)
    m12 = i2 + p.m2 * (lc2**2 + p.l1 * lc2 * c2)
    m22 = i2 + p.m2 * lc2**2
    g1 = (p.m1 * lc1 + p.m2 * p.l1) * GRAVITY * jnp.cos(q1) + p.m2 * lc2 * GRAVITY * jnp.cos(q1 + q2)
    g2 = p.m2 * lc2 * GRAVITY * jnp.cos(q1 + q2)
    h = p.m2 * p.l1 * lc2 * jnp.sin(q2)  # Coriolis/centrifugal coefficient
    return m11, m12, m22, g1, g2, h


def continuous_dynamics(
    x: jax.Array, u: jax.Array, params: TwoLinkParams = TwoLinkParams()
) -> jax.Array:
    """f(x, u) -> dx/dt for the 2R arm (closed-form 2x2 M(q) solve)."""
    q1, q2, dq1, dq2 = x[IDX_Q1], x[IDX_Q2], x[IDX_DQ1], x[IDX_DQ2]
    m11, m12, m22, g1, g2, h = _mass_gravity(params, q1, q2)
    c1 = -h * dq2 * (2.0 * dq1 + dq2)
    c2v = h * dq1 * dq1
    r1 = u[0] - c1 - g1
    r2 = u[1] - c2v - g2
    det = m11 * m22 - m12 * m12
    ddq1 = (m22 * r1 - m12 * r2) / det
    ddq2 = (m11 * r2 - m12 * r1) / det
    return jnp.stack([dq1, dq2, ddq1, ddq2])


def gravity_torques(
    q1: jax.Array, q2: jax.Array, params: TwoLinkParams = TwoLinkParams()
) -> jax.Array:
    """tau holding the arm statically at (q1, q2) — the natural input trim."""
    _, _, _, g1, g2, _ = _mass_gravity(params, q1, q2)
    return jnp.stack([g1, g2])


def state_bounds(dtype=jnp.float32) -> tuple[jax.Array, jax.Array]:
    lo = jnp.asarray([-2.9, -0.6, -6.0, -6.0], dtype)
    hi = jnp.asarray([0.3, 2.2, 6.0, 6.0], dtype)
    return lo, hi


def input_bounds(dtype=jnp.float32) -> tuple[jax.Array, jax.Array]:
    hi = jnp.asarray([20.0, 20.0], dtype)
    return -hi, hi


rk4 = quadrotor.rk4


def symbolic_twolink(
    dt: float = 0.02, params: TwoLinkParams | None = None
) -> SymbolicModel:
    """Two-link arm as a `SymbolicModel` — the same contract the quadrotor and
    cartpole give the MPC/GP-MPC stacks (TWOLINK_SPEC rides along)."""
    from gpmpc_tpu.models.residual import TWOLINK_SPEC  # avoid import cycle

    p = params or TwoLinkParams()
    fc = partial(continuous_dynamics, params=p)
    # Trim at the trajectory's mean posture (envs/twolink_env.py): gravity
    # compensation there keeps warm starts near-feasible. The trim constants
    # stay numpy, like the other families'.
    u_eq = np.asarray(
        gravity_torques(jnp.asarray(-jnp.pi / 2), jnp.asarray(0.7), p), np.float32
    )
    # The matching state trim: (x_eq, u_eq) is an equilibrium (zero rates at
    # the mean posture with gravity compensated), so the controller's prior
    # linearization is taken at a consistent point.
    x_eq = np.array([-np.pi / 2, 0.7, 0.0, 0.0], np.float32)
    return SymbolicModel(
        nx=NX, nu=NU, dt=float(dt), params=p, fc_func=fc, u_eq=u_eq, x_eq=x_eq,
        residual_spec=TWOLINK_SPEC,
    )
