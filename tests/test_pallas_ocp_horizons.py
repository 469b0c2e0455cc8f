"""The one kernel body across horizons, bound types and family shapes.

Every horizon runs the same stage loops, so each case is a horizon x
bound-type x shape point checked against `boxqp.solve_ocp_qp` per scenario.
"""

import numpy as np
import pytest

from gpmpc_tpu.ops.pallas_ocp import solve_ocp_qp_lanes
from tests.test_pallas_ocp import from_lanes, make_batch, reference_solutions, to_lanes

# (name, T, nx, nu, mehrotra, soft_rho, n_iter)
_CASES = [
    ("T1", 1, 4, 2, False, None, 10),
    ("T2_soft", 2, 4, 2, False, 2.0, 12),
    ("T13_mehrotra", 13, 4, 2, True, None, 10),
    ("T13_soft_mehrotra", 13, 4, 2, True, 2.0, 12),
    ("T25_cartpole", 25, 4, 1, False, None, 12),
    ("T25_twolink_soft", 25, 4, 2, False, 40.0, 12),
    ("T25_quadrotor", 25, 12, 4, False, None, 12),
    ("T25_quadrotor_mehrotra", 25, 12, 4, True, None, 10),
    ("T25_quadrotor_soft", 25, 12, 4, False, 2.0, 15),
    ("T25_quadrotor_soft_mehrotra", 25, 12, 4, True, 2.0, 12),
]


@pytest.mark.parametrize(
    "name,t,nx,nu,mehrotra,soft,n_iter", _CASES, ids=[c[0] for c in _CASES]
)
def test_horizon_parity(name, t, nx, nu, mehrotra, soft, n_iter):
    d = make_batch(11, t=t, scale=0.3, nx=nx, nu=nu)
    if soft is not None:
        # tight boxes: the soft bounds really activate
        d["lx"][:, 1:, :] = -0.2
        d["ux"][:, 1:, :] = 0.2
    dx, du, gap = solve_ocp_qp_lanes(
        to_lanes(d), n_ip=n_iter, mehrotra=mehrotra, soft_rho=soft, interpret=True
    )
    assert np.all(np.isfinite(np.asarray(gap)))
    assert np.asarray(dx).shape == (t + 1, nx, 8) and np.asarray(du).shape == (t, nu, 8)
    dx_ref, du_ref = reference_solutions(
        d, 15 if mehrotra else n_iter, rho=soft, mehrotra=mehrotra
    )
    # Mehrotra's adaptive centering (sigma = (gap_aff/gap)^3) cubes small f32
    # reduction-order differences between the two implementations, and the
    # reference freezes at gap 1e-8 while the kernel centers on to its floor:
    # the iterate paths differ by a few 1e-4 at most.
    atol = 1e-3 if mehrotra else 5e-4
    np.testing.assert_allclose(from_lanes(du), du_ref, atol=atol)
    np.testing.assert_allclose(from_lanes(dx), dx_ref, atol=atol)


@pytest.mark.parametrize("B", [1, 37, 130])
def test_batch_padding(B):
    """Batches that are not a whole number of scenario blocks are padded by
    repeating the last scenario and sliced back: shapes and per-scenario
    solutions are those of the unpadded problem."""
    d = make_batch(5, t=6, n=B, nx=4, nu=1)
    dx, du, gap = solve_ocp_qp_lanes(to_lanes(d), n_ip=10, interpret=True)
    assert np.asarray(dx).shape == (7, 4, B)
    assert np.asarray(du).shape == (6, 1, B)
    assert np.asarray(gap).shape == (B,)
    dx_ref, du_ref = reference_solutions(d, 10)
    np.testing.assert_allclose(from_lanes(du), du_ref, atol=5e-4)
    np.testing.assert_allclose(from_lanes(dx), dx_ref, atol=5e-4)
