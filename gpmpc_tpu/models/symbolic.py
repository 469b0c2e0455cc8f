"""The "symbolic model" layer, as traced JAX functions.

In the reference, `crazyflow.sim.symbolic.symbolic_attitude` builds a CasADi object
with `.x_sym/.u_sym/.fc_func/.df_func` so acados can code-generate C from analytic
expressions (contract established by call sites /root/reference/gpmpc/mpc.py:72-82 and
gpmpc/gpmpc.py:82-88,199). Under XLA no symbolic algebra system is needed: a traced
jnp function *is* the expression graph, and `jax.jacfwd` provides the exact Jacobians
that CasADi's `df_func` would. This module keeps the same API surface so controllers
are written against the identical contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Callable

import jax

from gpmpc_tpu.models import quadrotor
from gpmpc_tpu.models.quadrotor import QuadrotorParams


@dataclass(frozen=True)
class SymbolicModel:
    """Continuous-time dynamics model with AD Jacobians.

    Attributes mirror the reference symbolic-model contract:
      nx, nu, dt : problem dimensions and discretization step
      fc_func    : continuous dynamics f(x, u) -> dx/dt          (≙ model.fc_func)
      fd_func    : RK4 discretization  x_next = fd(x, u)         (≙ disc_dyn_expr)
      df_func    : (x, u) -> (dfdx, dfdu) continuous Jacobians   (≙ model.df_func)
    """

    nx: int
    nu: int
    dt: float
    params: object  # model-family parameter NamedTuple (QuadrotorParams, ...)
    fc_func: Callable[[jax.Array, jax.Array], jax.Array] = field(repr=False)
    # Input-space equilibrium/trim (the quadrotor's hover U_EQ); None = zero
    # input. Consumed by control/mpc.py::make_consts as the default input
    # reference, so each model family carries its own trim instead of the
    # controller guessing from dimensions.
    u_eq: jax.Array | None = field(default=None, repr=False)
    # State-space trim matching u_eq (the point where fc(x_eq, u_eq) ≈ 0);
    # None = the origin. The GP-MPC prior linearization (tightening-LQR ansatz,
    # control/gpmpc.py) linearizes at (x_eq, u_eq) so families whose trim is
    # away from the origin (two-link arm: gravity compensation at
    # q=(-pi/2, 0.7)) get a consistent equilibrium pair.
    x_eq: jax.Array | None = field(default=None, repr=False)
    # Residual-GP structure of this family (models/residual.py::ResidualSpec):
    # GP feature selection, mean injection, variance factors, target
    # preprocessing. None = family has no residual-learning structure (nominal
    # MPC only); the GP-MPC controller requires it.
    residual_spec: object | None = field(default=None, repr=False)

    def fd_func(self, x: jax.Array, u: jax.Array) -> jax.Array:
        return quadrotor.rk4(self.fc_func, x, u, self.dt)

    def df_func(self, x: jax.Array, u: jax.Array) -> tuple[jax.Array, jax.Array]:
        dfdx = jax.jacfwd(self.fc_func, argnums=0)(x, u)
        dfdu = jax.jacfwd(self.fc_func, argnums=1)(x, u)
        return dfdx, dfdu

    def dfd_func(self, x: jax.Array, u: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Jacobians of the RK4-discretized dynamics (used by the SQP linearizer)."""
        dfdx = jax.jacfwd(self.fd_func, argnums=0)(x, u)
        dfdu = jax.jacfwd(self.fd_func, argnums=1)(x, u)
        return dfdx, dfdu


def symbolic_attitude(dt: float = 0.02, params: dict | QuadrotorParams | None = None) -> SymbolicModel:
    """Build the attitude-interface quadrotor model.

    Drop-in analogue of `crazyflow.sim.symbolic.symbolic_attitude`
    (/root/reference/scripts/run_gp_mpc.py:146).
    """
    # Import here: models/residual.py imports sibling model modules, so the
    # spec registry loads lazily to keep the package import-cycle-free.
    from gpmpc_tpu.models.residual import QUADROTOR_SPEC

    if params is None:
        p = quadrotor.PRIOR_PARAMS
    elif isinstance(params, QuadrotorParams):
        p = params
    else:
        p = QuadrotorParams.from_dict(dict(params))
    fc = partial(quadrotor.continuous_dynamics, params=p)
    return SymbolicModel(
        nx=quadrotor.NX, nu=quadrotor.NU, dt=float(dt), params=p, fc_func=fc,
        u_eq=quadrotor.U_EQ, residual_spec=QUADROTOR_SPEC,
    )
