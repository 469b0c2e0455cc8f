"""Pallas IP QP kernel parity vs the XLA reference solver (interpret mode).

The kernel body is one program for every horizon (its stage loops are
`fori_loop`s) and every family shape (stage matrices are unrolled at trace
time), so these tests cover horizons, batch padding, soft bounds and
Mehrotra against `boxqp.solve_ocp_qp` per scenario.
Interpret-mode cost is dominated by compiling the kernel once per
configuration; the cases are kept small (T <= 25, B <= 130).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.ops.boxqp import OcpQpData, solve_ocp_qp
from gpmpc_tpu.ops.pallas_ocp import LanesQp, solve_ocp_qp_lanes

T, NX, NU, L = 5, 12, 4, 8
KEYS = ("A", "B", "r", "qdiag", "qx", "rdiag", "ru", "lx", "ux", "lu", "uu")


def make_batch(seed=0, t=T, scale=1.0, n=L, nx=NX, nu=NU):
    rng = np.random.default_rng(seed)
    # `scale` < 1 contracts the dynamics perturbation — long random horizons
    # need stable A products to stay conditioned.
    A = np.tile(np.eye(nx, dtype=np.float32), (n, t, 1, 1)) + (
        0.1 * scale
    ) * rng.normal(size=(n, t, nx, nx)).astype(np.float32)
    B = rng.normal(size=(n, t, nx, nu)).astype(np.float32) * 0.4
    r = rng.normal(size=(n, t, nx)).astype(np.float32) * 0.05
    qdiag = rng.uniform(0.5, 2.0, size=(n, t + 1, nx)).astype(np.float32)
    qx = rng.normal(size=(n, t + 1, nx)).astype(np.float32) * 0.5
    rdiag = rng.uniform(0.5, 2.0, size=(n, t, nu)).astype(np.float32)
    ru = rng.normal(size=(n, t, nu)).astype(np.float32) * 0.5
    lx = np.full((n, t + 1, nx), -1.5, np.float32)
    ux = np.full((n, t + 1, nx), 1.5, np.float32)
    lu = np.full((n, t, nu), -0.3, np.float32)
    uu = np.full((n, t, nu), 0.3, np.float32)
    # disable stage-0 state bounds (x0 pinned), like the SQP does
    lx[:, 0, :] = -1e8
    ux[:, 0, :] = 1e8
    return dict(A=A, B=B, r=r, qdiag=qdiag, qx=qx, rdiag=rdiag, ru=ru,
                lx=lx, ux=ux, lu=lu, uu=uu)


def to_lanes(d):
    """(B, ...) batch-leading -> (..., B) scenario-last."""
    return LanesQp(**{k: jnp.asarray(np.moveaxis(v, 0, -1)) for k, v in d.items()})


def from_lanes(x):
    return np.moveaxis(np.asarray(x), -1, 0)


@jax.jit
def _diag_qp(A, B, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu):
    return OcpQpData(
        A=A, B=B, r=r, Qxx=jax.vmap(jnp.diag)(qdiag), qx=qx,
        Ruu=jax.vmap(jnp.diag)(rdiag), ru=ru, lx=lx, ux=ux, lu=lu, uu=uu,
    )


def reference_solutions(d, n_iter, rho=None, mehrotra=False):
    """boxqp.solve_ocp_qp per scenario (vmapped), the plain reference."""
    def one(*a):
        sol = solve_ocp_qp(_diag_qp(*a), n_iter=n_iter, soft_x=rho, mehrotra=mehrotra)
        return sol.dx, sol.du

    dx, du = jax.jit(jax.vmap(one))(*[jnp.asarray(d[k]) for k in KEYS])
    return np.asarray(dx), np.asarray(du)


def test_lanes_ip_matches_reference():
    d = make_batch(0)
    n_iter = 12
    dx, du, gap = solve_ocp_qp_lanes(to_lanes(d), n_ip=n_iter, interpret=True)
    assert np.all(np.asarray(gap) < 1e-4)
    dx_ref, du_ref = reference_solutions(d, n_iter)
    np.testing.assert_allclose(from_lanes(du), du_ref, atol=2e-4)
    np.testing.assert_allclose(from_lanes(dx), dx_ref, atol=2e-4)


def test_lanes_ip_respects_bounds():
    d = make_batch(1)
    dx, du, _ = solve_ocp_qp_lanes(to_lanes(d), n_ip=12, interpret=True)
    assert np.asarray(du).max() <= 0.3 + 1e-4
    assert np.asarray(du).min() >= -0.3 - 1e-4
    # stage 1..T states inside their boxes
    assert np.asarray(dx)[1:].max() <= 1.5 + 1e-3
    assert np.asarray(dx)[1:].min() >= -1.5 - 1e-3


def test_lanes_adaptive_exit_matches_fixed():
    """With a tight tolerance the adaptive-exit kernel matches the fixed-count
    kernel (it only skips iterations that would be no-ops at convergence)."""
    qp_lanes = to_lanes(make_batch(2))
    dx_f, du_f, gap_f = solve_ocp_qp_lanes(qp_lanes, n_ip=12, interpret=True)
    dx_a, du_a, gap_a = solve_ocp_qp_lanes(
        qp_lanes, n_ip=12, adaptive_tol=1e-12, interpret=True
    )
    np.testing.assert_allclose(np.asarray(du_a), np.asarray(du_f), atol=1e-6)
    # and with a loose tolerance it still returns a feasible, near-optimal point
    dx_l, du_l, gap_l = solve_ocp_qp_lanes(
        qp_lanes, n_ip=12, adaptive_tol=1e-6, interpret=True
    )
    np.testing.assert_allclose(np.asarray(du_l), np.asarray(du_f), atol=1e-3)
    assert np.asarray(du_l).max() <= 0.3 + 1e-4


def test_lanes_mehrotra_matches_fixed():
    """Mehrotra predictor-corrector reaches (at least) the fixed-sigma solution
    quality in fewer iterations."""
    qp_lanes = to_lanes(make_batch(2))
    dx_f, du_f, gap_f = solve_ocp_qp_lanes(qp_lanes, n_ip=12, interpret=True)
    dx_m, du_m, gap_m = solve_ocp_qp_lanes(qp_lanes, n_ip=8, mehrotra=True, interpret=True)
    assert float(np.max(np.asarray(gap_m))) <= max(float(np.max(np.asarray(gap_f))), 1e-7)
    np.testing.assert_allclose(np.asarray(du_m), np.asarray(du_f), atol=5e-4)
    np.testing.assert_allclose(np.asarray(dx_m), np.asarray(dx_f), atol=5e-4)


def test_lanes_soft_matches_reference():
    """Soft state bounds in the kernel == the XLA soft IP, on a problem whose
    tight boxes force real violations (rho below the hard multipliers)."""
    d = make_batch(2)
    d["lx"][:, 1:, :] = -0.15  # tight: forces activations/violations
    d["ux"][:, 1:, :] = 0.15
    n_iter, rho = 15, 2.0
    dx, du, gap = solve_ocp_qp_lanes(
        to_lanes(d), n_ip=n_iter, soft_rho=rho, interpret=True
    )
    assert np.all(np.asarray(gap) < 1e-3)
    dx_ref, du_ref = reference_solutions(d, n_iter, rho)
    assert np.abs(dx_ref[:, 1:]).max() > 0.15 + 1e-3, "oracle should violate"
    np.testing.assert_allclose(from_lanes(du), du_ref, atol=5e-4)
    np.testing.assert_allclose(from_lanes(dx), dx_ref, atol=5e-4)


def test_lanes_soft_mehrotra_matches_reference():
    d = make_batch(3)
    d["lx"][:, 1:, :] = -0.2
    d["ux"][:, 1:, :] = 0.2
    rho = 3.0
    dx, du, gap = solve_ocp_qp_lanes(
        to_lanes(d), n_ip=10, soft_rho=rho, mehrotra=True, interpret=True
    )
    dx_ref, du_ref = reference_solutions(d, 15, rho, mehrotra=True)
    np.testing.assert_allclose(from_lanes(du), du_ref, atol=1e-3)
    np.testing.assert_allclose(from_lanes(dx), dx_ref, atol=1e-3)


def test_lanes_soft_crossed_bounds_finite():
    """Crossed boxes (over-aggressive tightening) stay well-posed in-kernel."""
    d = make_batch(4)
    d["lx"][:, 1:, :] = 0.3
    d["ux"][:, 1:, :] = -0.3  # lower ABOVE upper
    dx, du, gap = solve_ocp_qp_lanes(to_lanes(d), n_ip=15, soft_rho=5.0, interpret=True)
    assert np.all(np.isfinite(np.asarray(dx)))
    assert np.all(np.isfinite(np.asarray(du)))
    _, du_ref = reference_solutions(d, 15, 5.0)
    np.testing.assert_allclose(from_lanes(du), du_ref, atol=1e-3)
