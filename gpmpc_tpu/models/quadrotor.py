"""Quadrotor attitude-interface dynamics as plain JAX functions.

Replaces the reference's external CasADi symbolic model (`crazyflow.sim.symbolic.
symbolic_attitude`, used at /root/reference/scripts/run_gp_mpc.py:146) with jnp
functions. The CasADi symbolic layer in the reference exists only to hand analytic
expressions to acados' C code generator; under XLA the traced jnp function *is* the
symbolic expression, and `jax.jacfwd` replaces `model.df_func`.

Behavioral contracts preserved (SURVEY.md §7):
  * state order  [x, dx, y, dy, z, dz, phi, theta, psi, dphi, dtheta, dpsi]
    (/root/reference/gpmpc/plotting.py:198-211, scripts/run_gp_mpc.py:32-39)
  * input order  [thrust, phi_cmd, theta_cmd, psi_cmd], U_EQ = [0.3234, 0, 0, 0]
    (/root/reference/gpmpc/mpc.py:15)
  * state bounds (/root/reference/gpmpc/mpc.py:50-51) and input bounds (:53-54)
  * thrust->acceleration map  acc = a*T + b  (/root/reference/gpmpc/gpmpc.py:322-325)
  * first-order-fit attitude response rows driven by prior params c..l
    (scripts/gp_mpc_config.yaml:9-17)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

GRAVITY = 9.81

# Equilibrium input: hover thrust command of the *prior* model fit.
# Mirrors /root/reference/gpmpc/mpc.py:15.
# numpy, deliberately: a module-level jnp.array would initialize the XLA
# backend at import time (breaking pre-import jax.distributed.initialize).
U_EQ = np.array([0.3234, 0.0, 0.0, 0.0], dtype=np.float32)

STATE_LABELS = [
    "x", "d_x", "y", "d_y", "z", "d_z",
    "phi", "theta", "psi", "d_phi", "d_theta", "d_psi",
]

NX = 12
NU = 4

# State indices (kept symbolic for readability across the package).
IDX_X, IDX_DX, IDX_Y, IDX_DY, IDX_Z, IDX_DZ = 0, 1, 2, 3, 4, 5
IDX_PHI, IDX_THETA, IDX_PSI, IDX_DPHI, IDX_DTHETA, IDX_DPSI = 6, 7, 8, 9, 10, 11


class QuadrotorParams(NamedTuple):
    """Attitude-response model parameters.

    acc      = a * thrust_cmd + b
    dd_phi   = c * phi   + d * d_phi   + e * phi_cmd
    dd_theta = f * theta + h * d_theta + l * theta_cmd

    The keys a..l mirror scripts/gp_mpc_config.yaml:9-17 of the reference.
    """

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float
    h: float
    l: float  # noqa: E741 - name fixed by the reference config schema

    @classmethod
    def from_dict(cls, d: dict) -> "QuadrotorParams":
        return cls(**{k: float(d[k]) for k in ("a", "b", "c", "d", "e", "f", "h", "l")})


# The deliberately-mismatched prior fit shipped in the reference config
# (scripts/gp_mpc_config.yaml:9-17). At hover thrust 0.3234 it predicts only
# ~5.74 m/s^2 of specific thrust vs the ~9.81 required — the GP residual layer
# exists to learn exactly this gap.
PRIOR_PARAMS = QuadrotorParams(
    a=12.1432, b=1.8118, c=-72.08, d=-7.5755, e=39.8653, f=-72.08, h=-7.5755, l=39.8653
)

# "True" plant parameters used by the in-repo simulator (envs/drone.py). The
# reference simulates with the external crazyflow plant, whose identified thrust
# map and attitude loops differ from the prior fit above; we keep that structure
# with a thrust map that hovers near U_EQ and stiffer attitude loops, so the GP
# has a real residual to learn.
TRUE_PARAMS = QuadrotorParams(
    a=20.91, b=3.65, c=-130.3, d=-16.33, e=119.51, f=-99.94, h=-13.3, l=84.73
)


def thrust_acc(thrust_cmd: jax.Array, params: QuadrotorParams) -> jax.Array:
    """Collective-thrust-command -> specific-thrust magnitude [m/s^2].

    ≙ GPMPC.setup_symbolic_acceleration, /root/reference/gpmpc/gpmpc.py:322-325.
    """
    return params.a * thrust_cmd + params.b


def continuous_dynamics(x: jax.Array, u: jax.Array, params: QuadrotorParams) -> jax.Array:
    """Continuous-time attitude-interface quadrotor dynamics f(x, u).

    ≙ the reference's `model.fc_func` contract (call sites /root/reference/gpmpc/
    mpc.py:76-81, gpmpc/gpmpc.py:139,199). The thrust vector is rotated into the
    world frame by the ZYX-Euler attitude; the residual-GP rotation factors in the
    reference (gpmpc.py:194-196) are this expression evaluated at psi = 0.
    """
    phi, theta, psi = x[IDX_PHI], x[IDX_THETA], x[IDX_PSI]
    d_phi, d_theta, d_psi = x[IDX_DPHI], x[IDX_DTHETA], x[IDX_DPSI]
    thrust_cmd, phi_cmd, theta_cmd = u[0], u[1], u[2]

    acc = thrust_acc(thrust_cmd, params)
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    cth, sth = jnp.cos(theta), jnp.sin(theta)
    cpsi, spsi = jnp.cos(psi), jnp.sin(psi)

    dd_x = acc * (cphi * sth * cpsi + sphi * spsi)
    dd_y = acc * (cphi * sth * spsi - sphi * cpsi)
    dd_z = acc * cphi * cth - GRAVITY
    dd_phi = params.c * phi + params.d * d_phi + params.e * phi_cmd
    dd_theta = params.f * theta + params.h * d_theta + params.l * theta_cmd
    dd_psi = jnp.zeros_like(psi)

    return jnp.stack(
        [
            x[IDX_DX], dd_x,
            x[IDX_DY], dd_y,
            x[IDX_DZ], dd_z,
            d_phi, d_theta, d_psi,
            dd_phi, dd_theta, dd_psi,
        ]
    )


def rk4(f, x: jax.Array, u: jax.Array, dt: float) -> jax.Array:
    """Classic RK4 discretization of `dx/dt = f(x, u)`.

    ≙ the acados disc_dyn_expr construction, /root/reference/gpmpc/mpc.py:75-82 and
    gpmpc/gpmpc.py:204-209.
    """
    k1 = f(x, u)
    k2 = f(x + dt / 2 * k1, u)
    k3 = f(x + dt / 2 * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def state_bounds() -> tuple[jax.Array, jax.Array]:
    """Hard box state bounds. ≙ /root/reference/gpmpc/mpc.py:50-51."""
    low = jnp.array(
        [-2, -15, -2, -15, -0.05, -15, -1.5, -1.5, -10, -8.5, -8.5, -10], dtype=jnp.float32
    )
    high = jnp.array(
        [2, 15, 2, 15, 2, 15, 1.5, 1.5, 10, 8.5, 8.5, 10], dtype=jnp.float32
    )
    return low, high


def input_bounds() -> tuple[jax.Array, jax.Array]:
    """Hard box input bounds. ≙ /root/reference/gpmpc/mpc.py:53-54."""
    low = jnp.array([0.12, -0.43, -0.43, -0.43], dtype=jnp.float32)
    high = jnp.array([0.59, 0.43, 0.43, 0.43], dtype=jnp.float32)
    return low, high
