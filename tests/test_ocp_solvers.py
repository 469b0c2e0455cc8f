"""Unit tests for the Riccati / interior-point OCP-QP / SQP stack.

The reference ships no tests (SURVEY.md §4); oracles here are dense KKT solves and
scipy's generic NLP solver on small problems.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpmpc_tpu.ops.boxqp import BOUND_INF, OcpQpData, solve_ocp_qp
from gpmpc_tpu.ops.riccati import LqProblem, riccati_solve

T, NX, NU = 6, 4, 2


def random_lq(seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(T, NX, NX)) * 0.3 + np.eye(NX)
    B = rng.normal(size=(T, NX, NU))
    r = rng.normal(size=(T, NX)) * 0.1
    Qd = rng.uniform(0.5, 2.0, size=(T + 1, NX))
    Qxx = np.stack([np.diag(q) for q in Qd])
    qx = rng.normal(size=(T + 1, NX))
    Rd = rng.uniform(0.5, 2.0, size=(T, NU))
    Ruu = np.stack([np.diag(rr) for rr in Rd])
    ru = rng.normal(size=(T, NU))
    return LqProblem(
        *(jnp.asarray(a, dtype) for a in (A, B, r, Qxx, qx, Ruu, ru))
    )


def dense_kkt_solve(lq: LqProblem, dx0):
    """Oracle: solve the equality-constrained LQ problem via one dense KKT system."""
    A, B, r = np.asarray(lq.A), np.asarray(lq.B), np.asarray(lq.r)
    Qxx, qx = np.asarray(lq.Qxx), np.asarray(lq.qx)
    Ruu, ru = np.asarray(lq.Ruu), np.asarray(lq.ru)
    # Variables: dx_1..dx_T (free), du_0..du_{T-1}; dx_0 fixed.
    n_var = T * NX + T * NU

    def x_idx(k):  # k in 1..T
        return slice((k - 1) * NX, k * NX)

    def u_idx(k):
        return slice(T * NX + k * NU, T * NX + (k + 1) * NU)

    H = np.zeros((n_var, n_var))
    g = np.zeros(n_var)
    for k in range(1, T + 1):
        H[x_idx(k), x_idx(k)] = Qxx[k]
        g[x_idx(k)] = qx[k]
    for k in range(T):
        H[u_idx(k), u_idx(k)] = Ruu[k]
        g[u_idx(k)] = ru[k]
    # Constraints: dx_{k+1} - A dx_k - B du_k = r_k
    C = np.zeros((T * NX, n_var))
    c = np.zeros(T * NX)
    for k in range(T):
        row = slice(k * NX, (k + 1) * NX)
        C[row, x_idx(k + 1)] = np.eye(NX)
        if k > 0:
            C[row, x_idx(k)] = -A[k]
        C[row, u_idx(k)] = -B[k]
        c[row] = r[k] + (A[k] @ dx0 if k == 0 else 0)
    KKT = np.block([[H, C.T], [C, np.zeros((T * NX, T * NX))]])
    rhs = np.concatenate([-g, c])
    sol = np.linalg.solve(KKT, rhs)
    dx = np.concatenate([dx0[None], sol[: T * NX].reshape(T, NX)], axis=0)
    du = sol[T * NX : n_var].reshape(T, NU)
    return dx, du


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_riccati_matches_dense_kkt(seed):
    lq = random_lq(seed, dtype=jnp.float64)
    dx0 = np.zeros(NX)
    sol = jax.jit(riccati_solve)(lq, jnp.asarray(dx0, jnp.float64))
    dx_ref, du_ref = dense_kkt_solve(lq, dx0)
    np.testing.assert_allclose(np.asarray(sol.du), du_ref, atol=1e-10)
    np.testing.assert_allclose(np.asarray(sol.dx), dx_ref, atol=1e-10)


def test_boxqp_inactive_bounds_match_riccati():
    """With all bounds at +-inf the IP solution equals the unconstrained LQ one."""
    lq = random_lq(3, dtype=jnp.float64)
    inf = BOUND_INF
    qp = OcpQpData(
        A=lq.A, B=lq.B, r=lq.r, Qxx=lq.Qxx, qx=lq.qx, Ruu=lq.Ruu, ru=lq.ru,
        lx=jnp.full((T + 1, NX), -inf, jnp.float64),
        ux=jnp.full((T + 1, NX), inf, jnp.float64),
        lu=jnp.full((T, NU), -inf, jnp.float64),
        uu=jnp.full((T, NU), inf, jnp.float64),
    )
    sol = jax.jit(solve_ocp_qp)(qp)
    ric = riccati_solve(lq, jnp.zeros(NX, jnp.float64))
    np.testing.assert_allclose(np.asarray(sol.du), np.asarray(ric.du), atol=1e-5)


def slsqp_oracle(qp: OcpQpData):
    from scipy.optimize import minimize

    A, B, r = np.asarray(qp.A), np.asarray(qp.B), np.asarray(qp.r)
    Qxx, qx = np.asarray(qp.Qxx), np.asarray(qp.qx)
    Ruu, ru = np.asarray(qp.Ruu), np.asarray(qp.ru)
    n_var = T * NX + T * NU

    def unpack(v):
        dx = np.concatenate([np.zeros((1, NX)), v[: T * NX].reshape(T, NX)], axis=0)
        du = v[T * NX :].reshape(T, NU)
        return dx, du

    def fun(v):
        dx, du = unpack(v)
        c = 0.0
        for k in range(T + 1):
            c += 0.5 * dx[k] @ Qxx[k] @ dx[k] + qx[k] @ dx[k]
        for k in range(T):
            c += 0.5 * du[k] @ Ruu[k] @ du[k] + ru[k] @ du[k]
        return c

    def dyn(v):
        dx, du = unpack(v)
        return np.concatenate(
            [A[k] @ dx[k] + B[k] @ du[k] + r[k] - dx[k + 1] for k in range(T)]
        )

    lb = np.concatenate(
        [np.asarray(qp.lx)[1:].ravel(), np.asarray(qp.lu).ravel()]
    )
    ub = np.concatenate(
        [np.asarray(qp.ux)[1:].ravel(), np.asarray(qp.uu).ravel()]
    )
    res = minimize(
        fun,
        np.zeros(n_var),
        constraints=[{"type": "eq", "fun": dyn}],
        bounds=list(zip(lb, ub)),
        method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-12},
    )
    assert res.success, res.message
    return unpack(res.x)


def test_boxqp_active_bounds_vs_slsqp():
    lq = random_lq(4, dtype=jnp.float64)
    # Tight input bounds guaranteed to activate.
    qp = OcpQpData(
        A=lq.A, B=lq.B, r=lq.r, Qxx=lq.Qxx, qx=lq.qx, Ruu=lq.Ruu, ru=lq.ru,
        lx=jnp.full((T + 1, NX), -3.0, jnp.float64),
        ux=jnp.full((T + 1, NX), 3.0, jnp.float64),
        lu=jnp.full((T, NU), -0.2, jnp.float64),
        uu=jnp.full((T, NU), 0.2, jnp.float64),
    )
    sol = jax.jit(lambda q: solve_ocp_qp(q, n_iter=30))(qp)
    dx_ref, du_ref = slsqp_oracle(qp)
    assert np.max(np.abs(np.asarray(sol.du))) <= 0.2 + 1e-5
    np.testing.assert_allclose(np.asarray(sol.du), du_ref, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sol.dx), dx_ref, atol=1e-4)


def test_boxqp_batched_vmap():
    """The solver must vmap cleanly over a scenario batch (the batched throughput story)."""
    lqs = [random_lq(s, dtype=jnp.float32) for s in range(4)]
    qp = OcpQpData(
        A=jnp.stack([l.A for l in lqs]),
        B=jnp.stack([l.B for l in lqs]),
        r=jnp.stack([l.r for l in lqs]),
        Qxx=jnp.stack([l.Qxx for l in lqs]),
        qx=jnp.stack([l.qx for l in lqs]),
        Ruu=jnp.stack([l.Ruu for l in lqs]),
        ru=jnp.stack([l.ru for l in lqs]),
        lx=jnp.full((4, T + 1, NX), -3.0, jnp.float32),
        ux=jnp.full((4, T + 1, NX), 3.0, jnp.float32),
        lu=jnp.full((4, T, NU), -0.2, jnp.float32),
        uu=jnp.full((4, T, NU), 0.2, jnp.float32),
    )
    batched = jax.jit(jax.vmap(lambda q: solve_ocp_qp(q, n_iter=20)))
    sols = batched(qp)
    single = solve_ocp_qp(jax.tree.map(lambda a: a[1], qp), n_iter=20)
    np.testing.assert_allclose(np.asarray(sols.du[1]), np.asarray(single.du), atol=1e-5)


def _make_active_qp(seed):
    lq = random_lq(seed, dtype=jnp.float64)
    return OcpQpData(
        A=lq.A, B=lq.B, r=lq.r, Qxx=lq.Qxx, qx=lq.qx, Ruu=lq.Ruu, ru=lq.ru,
        lx=jnp.full((T + 1, NX), -3.0, jnp.float64),
        ux=jnp.full((T + 1, NX), 3.0, jnp.float64),
        lu=jnp.full((T, NU), -0.2, jnp.float64),
        uu=jnp.full((T, NU), 0.2, jnp.float64),
    )


def test_mehrotra_matches_fixed_sigma_solution():
    qp = _make_active_qp(4)
    sol_fix = jax.jit(lambda q: solve_ocp_qp(q, n_iter=30))(qp)
    sol_meh = jax.jit(lambda q: solve_ocp_qp(q, n_iter=30, mehrotra=True))(qp)
    np.testing.assert_allclose(np.asarray(sol_meh.du), np.asarray(sol_fix.du), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sol_meh.dx), np.asarray(sol_fix.dx), atol=1e-5)


@pytest.mark.slow
def test_mehrotra_fewer_iterations_to_tight_gap():
    """VERDICT item 9 'done' criterion: measured reduction in iterations to
    gap <= 1e-7 vs the fixed sigma=0.2 baseline."""
    def iters_to_gap(mehrotra, qp, tol=1e-7, max_iter=30):
        for n in range(1, max_iter + 1):
            gap = float(solve_ocp_qp(qp, n_iter=n, mehrotra=mehrotra).gap)
            if gap <= tol:
                return n
        return max_iter + 1

    wins = 0
    for seed in (4, 5, 6):
        qp = _make_active_qp(seed)
        n_fix = iters_to_gap(False, qp)
        n_meh = iters_to_gap(True, qp)
        assert n_meh <= n_fix, (seed, n_meh, n_fix)
        wins += int(n_meh < n_fix)
    assert wins >= 2, "Mehrotra should strictly reduce iterations on most problems"


def slsqp_soft_oracle(qp: OcpQpData, rho: float):
    """Oracle for the L1-soft-state-bound QP: explicit slack variables e >= 0
    with the penalty rho * sum(e), solved by scipy SLSQP."""
    from scipy.optimize import minimize

    A, B, r = np.asarray(qp.A), np.asarray(qp.B), np.asarray(qp.r)
    Qxx, qx = np.asarray(qp.Qxx), np.asarray(qp.qx)
    Ruu, ru = np.asarray(qp.Ruu), np.asarray(qp.ru)
    lx, ux = np.asarray(qp.lx), np.asarray(qp.ux)
    n_xu = T * NX + T * NU
    n_e = T * NX  # slack pair per bounded state entry (stages 1..T)
    n_var = n_xu + 2 * n_e

    def unpack(v):
        dx = np.concatenate([np.zeros((1, NX)), v[: T * NX].reshape(T, NX)], axis=0)
        du = v[T * NX : n_xu].reshape(T, NU)
        e_l = v[n_xu : n_xu + n_e].reshape(T, NX)
        e_u = v[n_xu + n_e :].reshape(T, NX)
        return dx, du, e_l, e_u

    def fun(v):
        dx, du, e_l, e_u = unpack(v)
        c = rho * (e_l.sum() + e_u.sum())
        for k in range(T + 1):
            c += 0.5 * dx[k] @ Qxx[k] @ dx[k] + qx[k] @ dx[k]
        for k in range(T):
            c += 0.5 * du[k] @ Ruu[k] @ du[k] + ru[k] @ du[k]
        return c

    def dyn(v):
        dx, du, _, _ = unpack(v)
        return np.concatenate(
            [A[k] @ dx[k] + B[k] @ du[k] + r[k] - dx[k + 1] for k in range(T)]
        )

    def soft_bounds(v):  # all entries must be >= 0
        dx, _, e_l, e_u = unpack(v)
        lo = (dx[1:] + e_l - lx[1:]).ravel()
        hi = (ux[1:] + e_u - dx[1:]).ravel()
        return np.concatenate([lo, hi])

    lb = np.concatenate(
        [np.full(T * NX, -np.inf), np.asarray(qp.lu).ravel(), np.zeros(2 * n_e)]
    )
    ub = np.concatenate(
        [np.full(T * NX, np.inf), np.asarray(qp.uu).ravel(), np.full(2 * n_e, np.inf)]
    )
    res = minimize(
        fun,
        np.concatenate([np.zeros(n_xu), np.full(2 * n_e, 0.1)]),
        constraints=[
            {"type": "eq", "fun": dyn},
            {"type": "ineq", "fun": soft_bounds},
        ],
        bounds=list(zip(lb, ub)),
        method="SLSQP",
        options={"maxiter": 800, "ftol": 1e-12},
    )
    assert res.success, res.message
    return unpack(res.x)


def _make_state_active_qp(seed):
    """QP whose STATE bounds activate (tight boxes, strong linear drift)."""
    lq = random_lq(seed, dtype=jnp.float64)
    return OcpQpData(
        A=lq.A, B=lq.B, r=lq.r, Qxx=lq.Qxx, qx=lq.qx, Ruu=lq.Ruu, ru=lq.ru,
        lx=jnp.full((T + 1, NX), -0.4, jnp.float64),
        ux=jnp.full((T + 1, NX), 0.4, jnp.float64),
        lu=jnp.full((T, NU), -2.0, jnp.float64),
        uu=jnp.full((T, NU), 2.0, jnp.float64),
    )


@pytest.mark.parametrize("mehrotra", [False, True])
def test_soft_exact_penalty_matches_hard(mehrotra):
    """L1 exact-penalty property: with rho above the hard problem's bound
    multipliers, the soft solution IS the hard solution."""
    qp = _make_state_active_qp(7)
    hard = jax.jit(lambda q: solve_ocp_qp(q, n_iter=40, mehrotra=mehrotra))(qp)
    soft = jax.jit(
        lambda q: solve_ocp_qp(q, n_iter=40, mehrotra=mehrotra, soft_x=200.0)
    )(qp)
    assert np.max(np.abs(np.asarray(hard.dx))) <= 0.4 + 1e-5  # bounds really active
    np.testing.assert_allclose(np.asarray(soft.du), np.asarray(hard.du), atol=2e-4)
    np.testing.assert_allclose(np.asarray(soft.dx), np.asarray(hard.dx), atol=2e-4)


@pytest.mark.parametrize("mehrotra", [False, True])
def test_soft_violating_solution_vs_slsqp(mehrotra):
    """With a small penalty it pays to violate: match the slack-NLP oracle."""
    qp = _make_state_active_qp(8)
    rho = 1.5
    sol = jax.jit(
        lambda q: solve_ocp_qp(q, n_iter=60, mehrotra=mehrotra, soft_x=rho)
    )(qp)
    dx_ref, du_ref, e_l, e_u = slsqp_soft_oracle(qp, rho)
    assert (e_l.max() > 1e-3) or (e_u.max() > 1e-3), "penalty should be violated"
    np.testing.assert_allclose(np.asarray(sol.du), du_ref, atol=2e-3)
    np.testing.assert_allclose(np.asarray(sol.dx), dx_ref, atol=2e-3)


def test_soft_feasible_with_crossed_bounds():
    """Crossed boxes (lx > ux — what over-aggressive chance tightening produces)
    are infeasible for the hard solver but well-posed for the soft one."""
    lq = random_lq(9, dtype=jnp.float64)
    qp = OcpQpData(
        A=lq.A, B=lq.B, r=lq.r, Qxx=lq.Qxx, qx=lq.qx, Ruu=lq.Ruu, ru=lq.ru,
        lx=jnp.full((T + 1, NX), 0.3, jnp.float64),   # lower ABOVE upper
        ux=jnp.full((T + 1, NX), -0.3, jnp.float64),
        lu=jnp.full((T, NU), -2.0, jnp.float64),
        uu=jnp.full((T, NU), 2.0, jnp.float64),
    )
    sol = jax.jit(lambda q: solve_ocp_qp(q, n_iter=40, soft_x=10.0))(qp)
    dx, du = np.asarray(sol.dx), np.asarray(sol.du)
    assert np.all(np.isfinite(dx)) and np.all(np.isfinite(du))
    # Dynamics must still hold exactly (Riccati enforces the equality path).
    A, B, r = np.asarray(qp.A), np.asarray(qp.B), np.asarray(qp.r)
    for k in range(T):
        np.testing.assert_allclose(dx[k + 1], A[k] @ dx[k] + B[k] @ du[k] + r[k], atol=1e-6)
    # The compromise lands between the crossed bound pair, not at either box.
    assert np.all(dx[1:] > -0.3 - 1e-6) and np.all(dx[1:] < 0.3 + 1e-6)
