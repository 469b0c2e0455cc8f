"""Box-constrained OCP-QP solver: infeasible-start primal-dual interior point.

JAX replacement for HPIPM (the reference's QP backend, selected at
/root/reference/gpmpc/mpc.py:115 / gpmpc/gpmpc.py:258 as
"PARTIAL_CONDENSING_HPIPM"). Same mathematical class of method — a primal-dual
interior point whose Newton systems are solved by stage-wise Riccati factorization —
but expressed as a fixed-iteration jittable JAX program so it batches with `vmap`
and shards with `pjit` instead of relying on panel-major CPU BLAS.

Problem (delta form around the current SQP iterate; x0 is pinned so dx_0 = 0):

    min  sum_k 1/2 dx_k'Qxx_k dx_k + qx_k'dx_k + 1/2 du_k'Ruu_k du_k + ru_k'du_k
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + r_k
         lx_k <= dx_k <= ux_k   (k = 1..T; pass +-BOUND_INF at k=0)
         lu_k <= du_k <= uu_k   (k = 0..T-1)

All inequality constraints in the reference OCP are boxes (A = [-I; I] rows,
/root/reference/gpmpc/mpc.py:165-170), optionally tightened per stage by the
chance-constraint parameters — so box-only support is complete, and keeps every
Newton system's barrier term diagonal (the Riccati blocks stay dense-free).

Bounds set to +-BOUND_INF participate harmlessly: their slacks stay huge and their
multipliers stay ~mu/BOUND_INF, contributing ~1e-16 to the barrier diagonal.

Soft (L1-penalized) state bounds — `soft_x`:
    HPIPM-style graceful degradation (the reference would instead die with an
    acados failure status, /root/reference/gpmpc/mpc.py:185): state bounds become
    lx - e_l <= dx <= ux + e_u with e >= 0 penalized by rho * e in the objective.
    In the interior point this is the *bounded-multiplier* formulation: the KKT
    system gains per-bound complementarities s*lam = mu AND e*(rho - lam) = mu
    (stationarity w.r.t. e gives nu = rho - lam >= 0), and eliminating (ds, de,
    dlam) elementwise keeps the barrier term diagonal — the Riccati structure is
    untouched, the effective barrier weight just changes from lam/s to
    1 / (s/lam + e/(rho - lam)). rho -> inf recovers the hard bound exactly; for
    finite rho the L1 exact-penalty property holds (solution identical to the
    hard problem whenever rho exceeds the hard multipliers). This also makes the
    QP unconditionally feasible — even *crossed* bounds (lx > ux after aggressive
    chance tightening) yield a well-posed solve.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpmpc_tpu.ops.riccati import LqProblem, riccati_solve

BOUND_INF = 1e8  # mirrors the reference's inactive-bound magnitude (mpc.py:158)


class OcpQpData(NamedTuple):
    """Stage-wise QP data; see module docstring for shapes/semantics."""

    A: jax.Array  # (T, nx, nx)
    B: jax.Array  # (T, nx, nu)
    r: jax.Array  # (T, nx)
    Qxx: jax.Array  # (T+1, nx, nx)
    qx: jax.Array  # (T+1, nx)
    Ruu: jax.Array  # (T, nu, nu)
    ru: jax.Array  # (T, nu)
    lx: jax.Array  # (T+1, nx)
    ux: jax.Array  # (T+1, nx)
    lu: jax.Array  # (T, nu)
    uu: jax.Array  # (T, nu)


class OcpQpSolution(NamedTuple):
    dx: jax.Array  # (T+1, nx)
    du: jax.Array  # (T, nu)
    gap: jax.Array  # final mean complementarity gap (scalar)


class _IpState(NamedTuple):
    dx: jax.Array
    du: jax.Array
    s_lx: jax.Array
    s_ux: jax.Array
    s_lu: jax.Array
    s_uu: jax.Array
    lam_lx: jax.Array
    lam_ux: jax.Array
    lam_lu: jax.Array
    lam_uu: jax.Array
    mu: jax.Array
    # L1 violation slacks for soft state bounds (zeros / unused in hard mode),
    # and the penalty-residual duals nu = rho - lam, tracked EXPLICITLY: in f32,
    # recomputing rho - lam quantizes to 0 once lam -> rho (eps * rho spacing),
    # and the soft algebra divides by nu.
    e_lx: jax.Array
    e_ux: jax.Array
    nu_lx: jax.Array
    nu_ux: jax.Array


def _fraction_to_boundary(vals, deltas, tau):
    """Largest alpha in (0, 1] with vals + alpha*deltas >= (1 - tau)*vals."""
    ratios = [
        jnp.where(d < 0, -tau * v / jnp.minimum(d, -1e-30), jnp.inf)
        for v, d in zip(vals, deltas)
    ]
    alpha = jnp.minimum(1.0, jnp.min(jnp.stack([jnp.min(r) for r in ratios])))
    return alpha


def solve_ocp_qp(
    qp: OcpQpData,
    n_iter: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    parallel_scan: bool = False,
    mehrotra: bool = False,
    soft_x: jax.Array | float | None = None,
    gap_tol: float | None = None,
) -> OcpQpSolution:
    """Solve the box-constrained OCP-QP. Fixed iteration count (jit/vmap friendly).

    parallel_scan=True routes the Newton solves through the O(log T)-depth
    associative-scan Riccati (ops/riccati_parallel.py) — the long-horizon path.

    mehrotra=True replaces the fixed centering parameter with Mehrotra's
    predictor-corrector (the scheme HPIPM itself uses): an affine predictor
    solve sets sigma = (gap_aff/gap)^3 adaptively and contributes the
    second-order ds*dlam complementarity correction. Two Riccati solves per
    iteration, but far fewer iterations to a given gap (measured in
    tests/test_ocp_solvers.py::test_mehrotra_fewer_iterations).

    soft_x (scalar or broadcastable to (T+1, nx)): L1 penalty weight rho that
    turns the state bounds soft (see module docstring). None keeps them hard.

    gap_tol: once the mean complementarity gap drops below it, remaining
    iterations are masked no-ops. The dtype default is a numerical-validity
    bound, not a convergence choice: in f32, iterating below gap ~1e-8 drives
    active-bound barrier weights past what a float32 Riccati/Cholesky can
    factor (observed NaN at gap ~4e-9) — an interior point cannot meaningfully
    center below ~sqrt(eps) of the variable scale.
    """
    if parallel_scan:
        from gpmpc_tpu.ops.riccati_parallel import riccati_solve_parallel as _riccati
    else:
        _riccati = riccati_solve
    T = qp.A.shape[0]
    nx = qp.A.shape[1]
    nu = qp.B.shape[2]
    dtype = qp.A.dtype
    s_min = jnp.asarray(1e-2, dtype)
    if gap_tol is None:
        gap_tol = 1e-14 if dtype == jnp.float64 else 1e-8
    soft = soft_x is not None
    if soft:
        rho = jnp.broadcast_to(jnp.asarray(soft_x, dtype), (T + 1, nx))

    dx0 = jnp.zeros((T + 1, nx), dtype)
    du0 = jnp.zeros((T, nu), dtype)
    e0 = jnp.full((T + 1, nx), s_min if soft else 0.0, dtype)
    s_lx = jnp.maximum(dx0 + e0 - qp.lx, s_min)
    s_ux = jnp.maximum(qp.ux + e0 - dx0, s_min)
    s_lu = jnp.maximum(du0 - qp.lu, s_min)
    s_uu = jnp.maximum(qp.uu - du0, s_min)
    mu_init = jnp.asarray(mu0, dtype)
    lam_lx0 = mu_init / s_lx
    lam_ux0 = mu_init / s_ux
    if soft:
        # Multipliers of soft bounds live in (0, rho); start well inside.
        lam_lx0 = jnp.minimum(lam_lx0, 0.49 * rho)
        lam_ux0 = jnp.minimum(lam_ux0, 0.49 * rho)
    zeros_x = jnp.zeros((T + 1, nx), dtype)
    state = _IpState(
        dx=dx0,
        du=du0,
        s_lx=s_lx,
        s_ux=s_ux,
        s_lu=s_lu,
        s_uu=s_uu,
        lam_lx=lam_lx0,
        lam_ux=lam_ux0,
        lam_lu=mu_init / s_lu,
        lam_uu=mu_init / s_uu,
        mu=mu_init,
        e_lx=e0,
        e_ux=e0,
        nu_lx=rho - lam_lx0 if soft else zeros_x,
        nu_ux=rho - lam_ux0 if soft else zeros_x,
    )
    # Complementarity pairs: (s, lam) for every bound, plus (e, rho - lam) for
    # each soft state bound.
    m_total = 2.0 * ((T + 1) * nx + T * nu)
    if soft:
        m_total += 2.0 * (T + 1) * nx

    def _gap(st: _IpState) -> jax.Array:
        g = (
            jnp.sum(st.s_lx * st.lam_lx) + jnp.sum(st.s_ux * st.lam_ux)
            + jnp.sum(st.s_lu * st.lam_lu) + jnp.sum(st.s_uu * st.lam_uu)
        )
        if soft:
            g = g + jnp.sum(st.e_lx * st.nu_lx) + jnp.sum(st.e_ux * st.nu_ux)
        return g / m_total

    def body(_, st: _IpState) -> _IpState:
        # Numerical-validity stop: below gap_tol the iteration is a masked
        # no-op (see docstring — f32 cannot factor the barrier past ~1e-8).
        done = _gap(st) <= gap_tol

        # Slack and complementarity residuals for each of the four bound sets.
        r_slx = st.dx + st.e_lx - qp.lx - st.s_lx
        r_sux = qp.ux + st.e_ux - st.dx - st.s_ux
        r_slu = st.du - qp.lu - st.s_lu
        r_suu = qp.uu - st.du - st.s_uu

        if soft:
            nu_lx = st.nu_lx
            nu_ux = st.nu_ux
            # Effective barrier weight of a soft bound: eliminating (ds, de,
            # dlam) gives dlam = -(w*(±ddx) + cg) with w = lam*nu/den,
            # den = s*nu + e*lam >= 2*mu > 0. The fused form never divides by
            # lam or nu alone — the naive w = 1/(s/lam + e/nu) NaNs in f32
            # once an inactive bound's lam underflows (0 * inf).
            # For a bound that is active but NOT violated, s and e BOTH shrink
            # like mu, so den ~ 2*mu and w diverges as lam*nu/(2*mu) — past
            # ~1e7-1e9 an f32 Riccati loses positive-definiteness (observed
            # NaN Cholesky under jit). Cap w via the denominator: a consistent
            # proximal regularization of that constraint (bound-violation
            # error <= |gradient|/W_MAX, far below solve tolerances).
            w_max = 1e16 if dtype == jnp.float64 else 1e6
            den_lx = st.s_lx * nu_lx + st.e_lx * st.lam_lx
            den_ux = st.s_ux * nu_ux + st.e_ux * st.lam_ux
            den_lx = jnp.maximum(den_lx, st.lam_lx * nu_lx * (1.0 / w_max))
            den_ux = jnp.maximum(den_ux, st.lam_ux * nu_ux * (1.0 / w_max))
            w_lx = st.lam_lx * nu_lx / den_lx
            w_ux = st.lam_ux * nu_ux / den_ux
        else:
            w_lx = st.lam_lx / st.s_lx
            w_ux = st.lam_ux / st.s_ux

        # Barrier diagonal (rhs-independent: shared by predictor and corrector).
        sigma_x = w_lx + w_ux
        sigma_u = st.lam_lu / st.s_lu + st.lam_uu / st.s_uu
        Qxx_hat = qp.Qxx + jax.vmap(jnp.diag)(sigma_x)
        Ruu_hat = qp.Ruu + jax.vmap(jnp.diag)(sigma_u)
        qx_base = (
            jnp.einsum("kij,kj->ki", qp.Qxx, st.dx) + qp.qx - st.lam_lx + st.lam_ux
        )
        ru_base = (
            jnp.einsum("kij,kj->ki", qp.Ruu, st.du) + qp.ru - st.lam_lu + st.lam_uu
        )
        # Dynamics infeasibility to be corrected by this Newton step.
        r_dyn = (
            jnp.einsum("kij,kj->ki", qp.A, st.dx[:-1])
            + jnp.einsum("kij,kj->ki", qp.B, st.du)
            + qp.r
            - st.dx[1:]
        )

        def newton_step(r_clx, r_cux, r_clu, r_cuu, r_elx=None, r_eux=None):
            """Eliminate (ds, de, dlam) for the given complementarity residuals
            and solve the stage-wise Newton system by Riccati. r_e* are the
            e*nu complementarity residuals (soft mode only)."""
            if soft:
                # cg = w * (r_s + r_c/lam - r_e/nu), computed fused over den
                # so no division by a (possibly underflowed-to-zero) lam/nu.
                cg_lx = (
                    st.lam_lx * nu_lx * r_slx + nu_lx * r_clx - st.lam_lx * r_elx
                ) / den_lx
                cg_ux = (
                    st.lam_ux * nu_ux * r_sux + nu_ux * r_cux - st.lam_ux * r_eux
                ) / den_ux
                corr_x = cg_lx - cg_ux
            else:
                corr_x = (r_clx + st.lam_lx * r_slx) / st.s_lx - (
                    r_cux + st.lam_ux * r_sux
                ) / st.s_ux
            corr_u = (r_clu + st.lam_lu * r_slu) / st.s_lu - (
                r_cuu + st.lam_uu * r_suu
            ) / st.s_uu
            sol = _riccati(
                LqProblem(
                    A=qp.A, B=qp.B, r=r_dyn, Qxx=Qxx_hat, qx=qx_base + corr_x,
                    Ruu=Ruu_hat, ru=ru_base + corr_u,
                ),
                jnp.zeros((nx,), dtype),
            )
            ddx, ddu = sol.dx, sol.du
            if soft:
                dlam_lx = -(w_lx * ddx + cg_lx)
                dlam_ux = w_ux * ddx - cg_ux
                # de from the e-complementarity (nu is explicit state, kept
                # positive by fraction-to-boundary), then ds exactly from the
                # slack equation — no division by lam anywhere.
                de_lx = (-r_elx + st.e_lx * dlam_lx) / nu_lx
                de_ux = (-r_eux + st.e_ux * dlam_ux) / nu_ux
                ds_lx = ddx + de_lx + r_slx
                ds_ux = -ddx + de_ux + r_sux
            else:
                # Hard path: the round-1 formulas, bit-for-bit.
                ds_lx = ddx + r_slx
                ds_ux = r_sux - ddx
                dlam_lx = -(r_clx + st.lam_lx * ds_lx) / st.s_lx
                dlam_ux = -(r_cux + st.lam_ux * ds_ux) / st.s_ux
                de_lx = de_ux = jnp.zeros_like(st.e_lx)
            ds_lu = ddu + r_slu
            ds_uu = r_suu - ddu
            dlam_lu = -(r_clu + st.lam_lu * ds_lu) / st.s_lu
            dlam_uu = -(r_cuu + st.lam_uu * ds_uu) / st.s_uu
            return (ddx, ddu), (ds_lx, ds_ux, ds_lu, ds_uu), (
                dlam_lx, dlam_ux, dlam_lu, dlam_uu,
            ), (de_lx, de_ux)

        def _alpha_primal(ds, de, t):
            vals = (st.s_lx, st.s_ux, st.s_lu, st.s_uu) + (
                (st.e_lx, st.e_ux) if soft else ()
            )
            deltas = ds + (de if soft else ())
            return _fraction_to_boundary(vals, deltas, t)

        def _alpha_dual(dlam, t):
            vals = (st.lam_lx, st.lam_ux, st.lam_lu, st.lam_uu)
            deltas = dlam
            if soft:
                # nu = rho - lam must also stay positive: d(nu) = -dlam.
                vals = vals + (nu_lx, nu_ux)
                deltas = deltas + (-dlam[0], -dlam[1])
            return _fraction_to_boundary(vals, deltas, t)

        gap_now = _gap(st)

        if mehrotra:
            # Affine predictor: pure Newton on complementarity (mu = 0).
            re_a = (st.e_lx * nu_lx, st.e_ux * nu_ux) if soft else (None, None)
            _, ds_a, dlam_a, de_a = newton_step(
                st.s_lx * st.lam_lx, st.s_ux * st.lam_ux,
                st.s_lu * st.lam_lu, st.s_uu * st.lam_uu,
                re_a[0], re_a[1],
            )
            a_p = _alpha_primal(ds_a, de_a, 1.0)
            a_d = _alpha_dual(dlam_a, 1.0)
            slacks = (st.s_lx, st.s_ux, st.s_lu, st.s_uu)
            lams = (st.lam_lx, st.lam_ux, st.lam_lu, st.lam_uu)
            gap_aff = sum(
                jnp.sum((s + a_p * ds) * (lam + a_d * dl))
                for s, ds, lam, dl in zip(slacks, ds_a, lams, dlam_a)
            )
            if soft:
                gap_aff = gap_aff + jnp.sum(
                    (st.e_lx + a_p * de_a[0]) * (nu_lx - a_d * dlam_a[0])
                ) + jnp.sum(
                    (st.e_ux + a_p * de_a[1]) * (nu_ux - a_d * dlam_a[1])
                )
            gap_aff = gap_aff / m_total
            sig = jnp.clip((gap_aff / jnp.maximum(gap_now, 1e-16)) ** 3, 1e-4, 1.0)
            # Floor the centering target at a dtype-appropriate value: pushing
            # mu below ~sqrt(eps)*typical-scale makes f32 complementarity
            # products pure rounding noise (observed NaNs in the soft path).
            t_floor = 1e-14 if dtype == jnp.float64 else 1e-10
            target = jnp.maximum(sig * gap_now, t_floor)
            # Corrector: centering + second-order ds_aff * dlam_aff terms
            # (d(e)*d(nu) = -de_aff * dlam_aff for the soft pairs).
            re_c = (
                (
                    st.e_lx * nu_lx - de_a[0] * dlam_a[0] - target,
                    st.e_ux * nu_ux - de_a[1] * dlam_a[1] - target,
                )
                if soft
                else (None, None)
            )
            (ddx, ddu), ds, dlam, de = newton_step(
                st.s_lx * st.lam_lx + ds_a[0] * dlam_a[0] - target,
                st.s_ux * st.lam_ux + ds_a[1] * dlam_a[1] - target,
                st.s_lu * st.lam_lu + ds_a[2] * dlam_a[2] - target,
                st.s_uu * st.lam_uu + ds_a[3] * dlam_a[3] - target,
                re_c[0], re_c[1],
            )
        else:
            re = (
                (st.e_lx * nu_lx - st.mu, st.e_ux * nu_ux - st.mu)
                if soft
                else (None, None)
            )
            (ddx, ddu), ds, dlam, de = newton_step(
                st.s_lx * st.lam_lx - st.mu, st.s_ux * st.lam_ux - st.mu,
                st.s_lu * st.lam_lu - st.mu, st.s_uu * st.lam_uu - st.mu,
                re[0], re[1],
            )
        ds_lx, ds_ux, ds_lu, ds_uu = ds
        dlam_lx, dlam_ux, dlam_lu, dlam_uu = dlam

        alpha_p = _alpha_primal(ds, de, tau)
        alpha_d = _alpha_dual(dlam, tau)

        new = _IpState(
            dx=st.dx + alpha_p * ddx,
            du=st.du + alpha_p * ddu,
            s_lx=st.s_lx + alpha_p * ds_lx,
            s_ux=st.s_ux + alpha_p * ds_ux,
            s_lu=st.s_lu + alpha_p * ds_lu,
            s_uu=st.s_uu + alpha_p * ds_uu,
            lam_lx=st.lam_lx + alpha_d * dlam_lx,
            lam_ux=st.lam_ux + alpha_d * dlam_ux,
            lam_lu=st.lam_lu + alpha_d * dlam_lu,
            lam_uu=st.lam_uu + alpha_d * dlam_uu,
            mu=st.mu,
            e_lx=st.e_lx + alpha_p * de[0] if soft else st.e_lx,
            e_ux=st.e_ux + alpha_p * de[1] if soft else st.e_ux,
            nu_lx=st.nu_lx - alpha_d * dlam_lx if soft else st.nu_lx,
            nu_ux=st.nu_ux - alpha_d * dlam_ux if soft else st.nu_ux,
        )
        gap = _gap(new)
        new = new._replace(mu=jnp.maximum(sigma * gap, 1e-12).astype(dtype))
        # Freeze once done (also discards any NaN computed past the validity
        # floor — jnp.where keeps the pre-iteration state).
        return jax.tree.map(lambda a, b: jnp.where(done, a, b), st, new)

    final = jax.lax.fori_loop(0, n_iter, body, state)
    return OcpQpSolution(dx=final.dx, du=final.du, gap=_gap(final))
