"""Analytic Jacobians of the (GP-augmented) quadrotor dynamics.

`jax.jacfwd` through the RK4 step pushes 16 tangents through every elementwise op
(including the GP kernel transcendentals) — measured as the dominant cost of a
warm-started SQP iteration once the QP moved into the Pallas kernel. The attitude
dynamics and the SE-kernel posterior mean both have cheap closed-form Jacobians;
this module evaluates them directly and chains them through RK4:

    dk1/dx = Jx(x1)                      dk1/du = Ju(x1)
    dk2/dx = Jx(x2) (I + dt/2 dk1/dx)    dk2/du = Jx(x2) dt/2 dk1/du + Ju(x2)
    ...
    A = I + dt/6 (dk1 + 2 dk2 + 2 dk3 + dk4)/dx,   B likewise.

Parity with jacfwd is locked by tests/test_jacobians.py (<= 1e-5).

Speed on the GPU against jacfwd: not measured. The RK4 chain here is batched
12x12 matmuls, the shape XLA lowers poorly, while jacfwd's per-tangent work is
elementwise. Default off (SqpConfig.analytic_jac).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gpmpc_tpu.models import quadrotor
from gpmpc_tpu.models.quadrotor import QuadrotorParams

NX, NU = quadrotor.NX, quadrotor.NU


def prior_jacobians(p: QuadrotorParams, x: jax.Array, u: jax.Array):
    """Continuous-time Jacobians (dfdx (12, 12), dfdu (12, 4)) of the attitude
    dynamics — the closed form of models/quadrotor.continuous_dynamics."""
    phi, theta, psi = x[6], x[7], x[8]
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    cth, sth = jnp.cos(theta), jnp.sin(theta)
    cpsi, spsi = jnp.cos(psi), jnp.sin(psi)
    acc = p.a * u[0] + p.b

    A = jnp.zeros((NX, NX), x.dtype)
    # kinematic rows: d(pos)/d(vel) and d(angle)/d(rate)
    for i, j in ((0, 1), (2, 3), (4, 5), (6, 9), (7, 10), (8, 11)):
        A = A.at[i, j].set(1.0)
    # dd_x = acc (cphi sth cpsi + sphi spsi)
    A = A.at[1, 6].set(acc * (-sphi * sth * cpsi + cphi * spsi))
    A = A.at[1, 7].set(acc * (cphi * cth * cpsi))
    A = A.at[1, 8].set(acc * (-cphi * sth * spsi + sphi * cpsi))
    # dd_y = acc (cphi sth spsi - sphi cpsi)
    A = A.at[3, 6].set(acc * (-sphi * sth * spsi - cphi * cpsi))
    A = A.at[3, 7].set(acc * (cphi * cth * spsi))
    A = A.at[3, 8].set(acc * (cphi * sth * cpsi + sphi * spsi))
    # dd_z = acc cphi cth - g
    A = A.at[5, 6].set(-acc * sphi * cth)
    A = A.at[5, 7].set(-acc * cphi * sth)
    # attitude response rows
    A = A.at[9, 6].set(p.c)
    A = A.at[9, 9].set(p.d)
    A = A.at[10, 7].set(p.f)
    A = A.at[10, 10].set(p.h)

    B = jnp.zeros((NX, NU), x.dtype)
    B = B.at[1, 0].set(p.a * (cphi * sth * cpsi + sphi * spsi))
    B = B.at[3, 0].set(p.a * (cphi * sth * spsi - sphi * cpsi))
    B = B.at[5, 0].set(p.a * cphi * cth)
    B = B.at[9, 1].set(p.e)
    B = B.at[10, 2].set(p.l)
    return A, B


def _gp_mean_and_grad(Zs_i, alpha_i, ell_i, sf2_i, z_i):
    """SE posterior mean and its gradient wrt the query point.

    mean = sum_m k_m alpha_m,  dmean/dz_d = sum_m k_m alpha_m (Z_{m,d} - z_d)/ell_d^2.
    ell_i may be a scalar (isotropic) or a (D,) ARD vector.
    """
    diff = Zs_i - z_i[None, :]  # (Ms, D)
    k = sf2_i * jnp.exp(-0.5 * jnp.sum((diff * diff) / (ell_i * ell_i), axis=-1))
    ka = k * alpha_i
    mean = jnp.sum(ka)
    grad = jnp.sum(ka[:, None] * diff, axis=0) / (ell_i * ell_i)
    return mean, grad


def augmented_jacobians(model, gp, x: jax.Array, u: jax.Array):
    """Continuous Jacobians of prior + GP residual dynamics (control/gpmpc.py::
    gp_residual): analytic kernel-mean gradients instead of 16 jacfwd tangents.

    Isotropic and ARD lengthscales (the kernel-mean gradient handles both).
    """
    A, B = prior_jacobians(model.params, x, u)

    phi, theta = x[6], x[7]
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    cth, sth = jnp.cos(theta), jnp.sin(theta)
    ell = jax.nn.softplus(gp.hypers.raw_lengthscale)
    sf2 = jax.nn.softplus(gp.hypers.raw_outputscale)

    zT = jnp.stack([u[0], jnp.zeros_like(u[0]), jnp.zeros_like(u[0])])
    zR = jnp.stack([x[6], x[9], u[1]])
    zP = jnp.stack([x[7], x[10], u[2]])
    Tp, dT = _gp_mean_and_grad(gp.Zs[0], gp.alpha_s[0], ell[0], sf2[0], zT)
    Rp, dR = _gp_mean_and_grad(gp.Zs[1], gp.alpha_s[1], ell[1], sf2[1], zR)
    Pp, dP = _gp_mean_and_grad(gp.Zs[2], gp.alpha_s[2], ell[2], sf2[2], zP)
    dT0 = dT[0]  # only the thrust component of zT is live

    # res row 1: Tp cphi sth ; row 3: -Tp sphi ; row 5: Tp cphi cth
    A = A.at[1, 6].add(-Tp * sphi * sth)
    A = A.at[1, 7].add(Tp * cphi * cth)
    A = A.at[3, 6].add(-Tp * cphi)
    A = A.at[5, 6].add(-Tp * sphi * cth)
    A = A.at[5, 7].add(-Tp * cphi * sth)
    B = B.at[1, 0].add(dT0 * cphi * sth)
    B = B.at[3, 0].add(-dT0 * sphi)
    B = B.at[5, 0].add(dT0 * cphi * cth)
    # res row 9: Rp(phi, dphi, u1) ; row 10: Pp(theta, dtheta, u2)
    A = A.at[9, 6].add(dR[0])
    A = A.at[9, 9].add(dR[1])
    B = B.at[9, 1].add(dR[2])
    A = A.at[10, 7].add(dP[0])
    A = A.at[10, 10].add(dP[1])
    B = B.at[10, 2].add(dP[2])
    return A, B


def rk4_discrete_jacobians(fc, fc_jac, x: jax.Array, u: jax.Array, dt: float):
    """(fnext, A_d, B_d) of the RK4 step, chaining analytic continuous Jacobians.

    fc(x, u) -> dx/dt;  fc_jac(x, u) -> (Jx (12,12), Ju (12,4)).
    """
    eye = jnp.eye(NX, dtype=x.dtype)

    x1 = x
    k1 = fc(x1, u)
    J1x, J1u = fc_jac(x1, u)
    x2 = x + 0.5 * dt * k1
    k2 = fc(x2, u)
    J2x_c, J2u_c = fc_jac(x2, u)
    dk2x = J2x_c @ (eye + 0.5 * dt * J1x)
    dk2u = J2x_c @ (0.5 * dt * J1u) + J2u_c
    x3 = x + 0.5 * dt * k2
    k3 = fc(x3, u)
    J3x_c, J3u_c = fc_jac(x3, u)
    dk3x = J3x_c @ (eye + 0.5 * dt * dk2x)
    dk3u = J3x_c @ (0.5 * dt * dk2u) + J3u_c
    x4 = x + dt * k3
    k4 = fc(x4, u)
    J4x_c, J4u_c = fc_jac(x4, u)
    dk4x = J4x_c @ (eye + dt * dk3x)
    dk4u = J4x_c @ (dt * dk3u) + J4u_c

    fnext = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    A_d = eye + dt / 6.0 * (J1x + 2 * dk2x + 2 * dk3x + dk4x)
    B_d = dt / 6.0 * (J1u + 2 * dk2u + 2 * dk3u + dk4u)
    return fnext, A_d, B_d


def make_augmented_fd_jac(model, gp):
    """(x, u) -> (fnext, A_d, B_d) for the GP-augmented discrete dynamics."""
    from gpmpc_tpu.control.gpmpc import gp_residual

    def fc(x, u):
        return model.fc_func(x, u) + gp_residual(gp, x, u)

    def fc_jac(x, u):
        return augmented_jacobians(model, gp, x, u)

    return partial(rk4_discrete_jacobians, fc, fc_jac, dt=model.dt)
