"""Scenario-blocked Pallas kernel for the box-constrained OCP-QP interior point.

Why this kernel exists: the OCP's per-stage blocks are 12x12 / 12x4, and the
plain XLA path (vmapped `boxqp.solve_ocp_qp`) runs the interior point as a long
sequential loop of tiny batched kernels — IP iterations x 2 sweeps x T stages,
each a handful of launches. This kernel runs the whole QP solve — `n_ip`
interior-point iterations, each a backward Riccati sweep, a forward rollout,
slack/dual updates and fraction-to-boundary steps — in ONE launch.

Layout: every array carries the scenario axis LAST, e.g. A is (T, nx, nx, B).
The launch grid runs over blocks of S consecutive scenarios (`SCENARIO_BLOCK`);
inside a program every scalar of the textbook algorithm is an (S,) vector, one
scenario per thread. Stage matrices are unrolled at trace time into Python lists
of such vectors, so the body is elementwise float32 arithmetic only (no dot
products, hence no TF32 rounding) plus (S,)-wide loads and stores at static
matrix indices and a dynamic stage index. The stage loops are `fori_loop`s, so
one body serves every horizon.

Triton has no scratch memory: the IP state (slacks, duals, soft-bound slacks),
the Riccati gains, the Mehrotra factor stores and the Newton directions live in
extra outputs in global memory. Every thread reads back only the entries it
wrote itself (same (S,) layout for every access), so no barrier is needed.

Semantics are identical to `boxqp.solve_ocp_qp` restricted to DIAGONAL stage
cost Hessians (always true here: Gauss-Newton of LINEAR_LS with diagonal Q/R
plus the diagonal IP barrier), with two additions: an adaptive exit once every
scenario of a block has its centering parameter below `adaptive_tol`, and a
factorize-once Mehrotra corrector. Verified in tests/test_pallas_ocp.py.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Scenarios per program. One warp runs a block, one scenario per thread, so
# 24 of its 32 threads idle; the narrow block puts the default batch (B=1024)
# on 128 programs, about one per SM. On the H100 a 16-wide block was no
# faster at B=1024, and a 32-wide one crashed the process.
SCENARIO_BLOCK = 8


class LanesQp(NamedTuple):
    """QP data with the scenario axis last. Shapes (T = horizon, B = batch):
    A (T,nx,nx,B)  B (T,nx,nu,B)  r (T,nx,B)
    qdiag (T+1,nx,B)  qx (T+1,nx,B)  rdiag (T,nu,B)  ru (T,nu,B)
    lx/ux (T+1,nx,B)  lu/uu (T,nu,B)
    """

    A: jax.Array
    B: jax.Array
    r: jax.Array
    qdiag: jax.Array
    qx: jax.Array
    rdiag: jax.Array
    ru: jax.Array
    lx: jax.Array
    ux: jax.Array
    lu: jax.Array
    uu: jax.Array


class _Bound(NamedTuple):
    """One box-constrained variable of one stage, each field an (S,) vector:
    value v in [lo, hi], slacks s, duals lam, and (soft state bounds only) the
    L1 violation slacks e and explicit penalty duals nu = rho - lam."""

    v: jax.Array
    lo: jax.Array
    hi: jax.Array
    sl: jax.Array
    su: jax.Array
    ll: jax.Array
    lu: jax.Array
    el: jax.Array | None = None
    eu: jax.Array | None = None
    nl: jax.Array | None = None
    nu: jax.Array | None = None


# ---- per-variable IP algebra (ops/boxqp.py, elementwise) --------------------


def _weights(b: _Bound):
    """Barrier weights (w_l, w_u) and, for soft bounds, the fused denominators
    den = s*nu + e*lam. The soft form never divides by lam or nu alone (the
    naive 1/(s/lam + e/nu) NaNs in f32 once lam underflows); the max() caps w
    at 1e6, a proximal regularization that keeps the f32 Riccati positive
    definite for active-not-violated soft bounds (see boxqp.py)."""
    if b.el is None:
        return b.ll / b.sl, b.lu / b.su, None, None
    den_l = jnp.maximum(b.sl * b.nl + b.el * b.ll, b.ll * b.nl * 1e-6)
    den_u = jnp.maximum(b.su * b.nu + b.eu * b.lu, b.lu * b.nu * 1e-6)
    return b.ll * b.nl / den_l, b.lu * b.nu / den_u, den_l, den_u


def _slack_residuals(b: _Bound):
    r_sl = b.v - b.lo - b.sl
    r_su = b.hi - b.v - b.su
    if b.el is not None:
        r_sl = r_sl + b.el
        r_su = r_su + b.eu
    return r_sl, r_su


def _rc_affine(b: _Bound):
    """Complementarity residuals of the pure Newton (affine) step."""
    if b.el is None:
        return b.sl * b.ll, b.su * b.lu, None, None
    return b.sl * b.ll, b.su * b.lu, b.el * b.nl, b.eu * b.nu


def _rc_shift(rc, shift):
    return tuple(None if r is None else r - shift for r in rc)


def _correction(b: _Bound, rc):
    """RHS correction of the Newton system from eliminating (ds, de, dlam)."""
    r_sl, r_su = _slack_residuals(b)
    r_cl, r_cu, r_el, r_eu = rc
    if b.el is None:
        return (r_cl + b.ll * r_sl) / b.sl - (r_cu + b.lu * r_su) / b.su
    _, _, den_l, den_u = _weights(b)
    cg_l = (b.ll * b.nl * r_sl + b.nl * r_cl - b.ll * r_el) / den_l
    cg_u = (b.lu * b.nu * r_su + b.nu * r_cu - b.lu * r_eu) / den_u
    return cg_l - cg_u


def _directions(b: _Bound, d, rc):
    """(ds_l, ds_u, dl_l, dl_u, de_l, de_u) for the primal step d."""
    r_sl, r_su = _slack_residuals(b)
    r_cl, r_cu, r_el, r_eu = rc
    if b.el is None:
        ds_l = d + r_sl
        ds_u = r_su - d
        dl_l = -(r_cl + b.ll * ds_l) / b.sl
        dl_u = -(r_cu + b.lu * ds_u) / b.su
        return ds_l, ds_u, dl_l, dl_u, None, None
    w_l, w_u, den_l, den_u = _weights(b)
    cg_l = (b.ll * b.nl * r_sl + b.nl * r_cl - b.ll * r_el) / den_l
    cg_u = (b.lu * b.nu * r_su + b.nu * r_cu - b.lu * r_eu) / den_u
    dl_l = -(w_l * d + cg_l)
    dl_u = w_u * d - cg_u
    de_l = (-r_el + b.el * dl_l) / b.nl
    de_u = (-r_eu + b.eu * dl_u) / b.nu
    ds_l = d + de_l + r_sl
    ds_u = -d + de_u + r_su
    return ds_l, ds_u, dl_l, dl_u, de_l, de_u


def _rc_corrector(b: _Bound, d_aff, target):
    """Mehrotra corrector residuals: centering + second-order ds_aff*dlam_aff
    terms (d(e)*d(nu) = -de_aff*dlam_aff for the soft pairs)."""
    ds_l, ds_u, dl_l, dl_u, de_l, de_u = _directions(b, d_aff, _rc_affine(b))
    r_cl = b.sl * b.ll + ds_l * dl_l - target
    r_cu = b.su * b.lu + ds_u * dl_u - target
    if b.el is None:
        return r_cl, r_cu, None, None
    return r_cl, r_cu, b.el * b.nl - de_l * dl_l - target, b.eu * b.nu - de_u * dl_u - target


def _ratio(v, d, t):
    return jnp.where(d < 0, -t * v / jnp.minimum(d, -1e-30), jnp.inf)


def _step_limits(b: _Bound, dirs, t, a_p, a_d):
    """Fold this variable's fraction-to-boundary limits into (a_p, a_d)."""
    ds_l, ds_u, dl_l, dl_u, de_l, de_u = dirs
    a_p = jnp.minimum(a_p, jnp.minimum(_ratio(b.sl, ds_l, t), _ratio(b.su, ds_u, t)))
    a_d = jnp.minimum(a_d, jnp.minimum(_ratio(b.ll, dl_l, t), _ratio(b.lu, dl_u, t)))
    if b.el is not None:
        # e stays positive (primal); nu = rho - lam stays positive (dual).
        a_p = jnp.minimum(a_p, jnp.minimum(_ratio(b.el, de_l, t), _ratio(b.eu, de_u, t)))
        a_d = jnp.minimum(a_d, jnp.minimum(_ratio(b.nl, -dl_l, t), _ratio(b.nu, -dl_u, t)))
    return a_p, a_d


def _complementarity(b: _Bound):
    g = b.sl * b.ll + b.su * b.lu
    if b.el is not None:
        g = g + b.el * b.nl + b.eu * b.nu
    return g


def _complementarity_after(b: _Bound, dirs, a_p, a_d):
    ds_l, ds_u, dl_l, dl_u, de_l, de_u = dirs
    g = (b.sl + a_p * ds_l) * (b.ll + a_d * dl_l) + (b.su + a_p * ds_u) * (b.lu + a_d * dl_u)
    if b.el is not None:
        g = g + (b.el + a_p * de_l) * (b.nl - a_d * dl_l)
        g = g + (b.eu + a_p * de_u) * (b.nu - a_d * dl_u)
    return g


# ---- the kernel ---------------------------------------------------------------


class _Opts(NamedTuple):
    n_ip: int
    mu0: float
    sigma: float
    tau: float
    adaptive_tol: float | None
    mehrotra: bool
    soft_rho: float | None


def _tril(n):
    return [(c, d) for c in range(n) for d in range(c + 1)]


def _chol(G, n):
    """Lane-wise Cholesky of the (n, n) SPD matrix given as {(c, d): vec} for
    c >= d; returns the lower factor in the same form."""
    Lc = {}
    for c in range(n):
        acc = G[(c, c)]
        for d in range(c):
            acc = acc - Lc[(c, d)] * Lc[(c, d)]
        Lc[(c, c)] = jnp.sqrt(jnp.maximum(acc, 1e-12))
        for e in range(c + 1, n):
            acc = G[(e, c)]
            for d in range(c):
                acc = acc - Lc[(e, d)] * Lc[(c, d)]
            Lc[(e, c)] = acc / Lc[(c, c)]
    return Lc


def _solve_lower(Lc, rhs):
    """Forward substitution L y = rhs."""
    y = []
    for c in range(len(rhs)):
        acc = rhs[c]
        for d in range(c):
            acc = acc - Lc[(c, d)] * y[d]
        y.append(acc / Lc[(c, c)])
    return y


def _solve_upper(Lc, rhs):
    """Back substitution L' x = rhs."""
    n = len(rhs)
    x = [None] * n
    for c in reversed(range(n)):
        acc = rhs[c]
        for d in range(c + 1, n):
            acc = acc - Lc[(d, c)] * x[d]
        x[c] = acc / Lc[(c, c)]
    return x


class _Rows:
    """A (rows, S) kernel ref viewed with its logical leading shape: indexing
    with one scalar per leading dimension reads or writes one (S,) row. Every
    buffer is passed flattened to 2-D so each access is one row offset."""

    def __init__(self, ref, lead):
        self.ref = ref
        self.strides = [int(math.prod(lead[d + 1:])) for d in range(len(lead))]

    def _row(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        row = 0
        for i, st in zip(idx, self.strides):
            row = row + i * st
        return row

    def __getitem__(self, idx):
        return self.ref[self._row(idx)]

    def __setitem__(self, idx, val):
        self.ref[self._row(idx)] = val


def _ip_kernel(o: _Opts, T: int, nx: int, nu: int, leads, *flat_refs):
    """One program: the whole IP solve for one block of scenarios.

    Every loop over stages or matrix rows is a `fori_loop`, and only the
    short inner products (length nx or nu) are unrolled, so each piece of the
    algebra appears once in the program. Matrices that the Riccati recursion
    carries from stage to stage (P, P A, P B) live in per-block buffers."""
    soft = o.soft_rho is not None
    refs = [_Rows(ref, lead) for ref, lead in zip(flat_refs, leads)]
    (A, Bm, r, qdiag, qx, rdiag, ru, lx, ux, lu, uu,
     dx, du, gap_out, slx, sux, slu, suu, llx, lux, llu, luu,
     rdyn, K, kff, Pr, Lf, Y, ddx, ddu,
     P, p, PA, PB, frp, qh, sgx, rh, sgu, *rest) = refs
    if o.mehrotra:
        ddxa, ddua, *rest = rest
    else:
        ddxa = ddua = None
    if soft:
        elx, eux, nulx, nuux = rest
        x_group = (dx, lx, ux, slx, sux, llx, lux, elx, eux, nulx, nuux)
    else:
        x_group = (dx, lx, ux, slx, sux, llx, lux)
    u_group = (du, lu, uu, slu, suu, llu, luu)
    S = flat_refs[0].shape[-1]
    f32 = jnp.float32
    s_min = 1e-2
    m_total = 2.0 * ((T + 1) * nx + T * nu) + (2.0 * (T + 1) * nx if soft else 0.0)
    floor = 1e-8 if soft else 1e-12  # per-scenario f32 validity floor on mu
    zeros = jnp.zeros((S,), f32)
    fori = jax.lax.fori_loop

    def load(group, k, i):
        return _Bound(*(ref[k, i] for ref in group))

    def store(group, k, i, b: _Bound):
        for ref, val in zip(group[3:], b[3:]):
            ref[k, i] = val

    def over(n, body, carry):
        return fori(0, n, body, carry)

    def x_and_u(k, x_body, u_body, carry):
        """x-variables of stage k, then (k < T) its u-variables."""
        carry = over(nx, lambda i, c: x_body(k, i, c), carry)
        return over(nu, lambda i, c: u_body(k, i, c), carry)

    def backward(stage):
        """stage(k) for k = T-1 .. 0."""
        def body(i, c):
            stage(T - 1 - i)
            return c

        fori(0, T, body, 0)

    def all_stages(x_body, u_body, carry):
        carry = fori(0, T, lambda k, c: x_and_u(k, x_body, u_body, c), carry)
        return over(nx, lambda i, c: x_body(T, i, c), carry)

    # ---- init: dx = du = 0, slacks clipped to the interior, duals mu0/s ----
    def init_x(k, i, g):
        lo, hi = lx[k, i], ux[k, i]
        dx[k, i] = zeros
        if soft:
            sl = jnp.maximum(s_min - lo, s_min)
            su = jnp.maximum(hi + s_min, s_min)
            ll = jnp.minimum(o.mu0 / sl, 0.49 * o.soft_rho)
            lu_ = jnp.minimum(o.mu0 / su, 0.49 * o.soft_rho)
            e = jnp.full((S,), s_min, f32)
            nb = _Bound(None, lo, hi, sl, su, ll, lu_, e, e,
                        o.soft_rho - ll, o.soft_rho - lu_)
        else:
            sl = jnp.maximum(-lo, s_min)
            su = jnp.maximum(hi, s_min)
            nb = _Bound(None, lo, hi, sl, su, o.mu0 / sl, o.mu0 / su)
        store(x_group, k, i, nb)
        return g + _complementarity(nb)

    def init_u(k, i, g):
        lo, hi = lu[k, i], uu[k, i]
        du[k, i] = zeros
        sl = jnp.maximum(-lo, s_min)
        su = jnp.maximum(hi, s_min)
        nb = _Bound(None, lo, hi, sl, su, o.mu0 / sl, o.mu0 / su)
        store(u_group, k, i, nb)
        return g + _complementarity(nb)

    gap0 = all_stages(init_x, init_u, zeros) / m_total

    # ---- complementarity residuals of the three step kinds ----
    def residual(rc_mode, shift, b, d_aff):
        if rc_mode == "corrector":
            return _rc_corrector(b, d_aff, shift)
        rc = _rc_affine(b)
        return _rc_shift(rc, shift) if rc_mode == "centered" else rc

    def aff_dir(group, k, i):
        """The stored affine direction of this variable (corrector only)."""
        return (ddxa if group is x_group else ddua)[k, i]

    def bound_rc(rc_mode, shift, group, k, i):
        b = load(group, k, i)
        d_aff = aff_dir(group, k, i) if rc_mode == "corrector" else None
        return b, residual(rc_mode, shift, b, d_aff)

    def stage_terms(rc_mode, shift, k, with_u=True):
        """Newton RHS (qhat, rhat) and barrier diagonals (sgx, sgu) of stage k."""
        def x_body(i, c):
            b, rc = bound_rc(rc_mode, shift, x_group, k, i)
            qh[i] = qdiag[k, i] * b.v + qx[k, i] - b.ll + b.lu + _correction(b, rc)
            w_l, w_u, _, _ = _weights(b)
            sgx[i] = w_l + w_u
            return c

        def u_body(i, c):
            b, rc = bound_rc(rc_mode, shift, u_group, k, i)
            rh[i] = rdiag[k, i] * b.v + ru[k, i] - b.ll + b.lu + _correction(b, rc)
            w_l, w_u, _, _ = _weights(b)
            sgu[i] = w_l + w_u
            return c

        over(nx, x_body, 0)
        if with_u:
            over(nu, u_body, 0)

    # ---- one IP iteration, as passes over the stages ----
    def dynamics_residual():
        """rdyn_k = A_k dx_k + B_k du_k + r_k - dx_{k+1}."""
        def row(k, i, c):
            acc = r[k, i] - dx[k + 1, i]
            for j in range(nx):
                acc = acc + A[k, i, j] * dx[k, j]
            for j in range(nu):
                acc = acc + Bm[k, i, j] * du[k, j]
            rdyn[k, i] = acc
            return c

        fori(0, T, lambda k, c: over(nx, lambda i, c: row(k, i, c), c), 0)

    def sweep_matrix(rc_mode, shift):
        """Backward Riccati sweep that factorizes: stores K, kff and the
        per-stage factor stores Pr = P_{k+1} rdyn_k, chol(Guu) and
        Y = chol(Guu)^{-1} Gxu' (Y also forms P_k = A'PA + D - Y'Y; the
        Mehrotra corrector reuses all three in its vector sweep)."""
        stage_terms(rc_mode, shift, T, with_u=False)

        def init_row(i, c):
            d = qdiag[T, i] + sgx[i]
            for j in range(nx):
                P[i, j] = jnp.where(i == j, d, zeros)
            p[i] = qh[i]
            return c

        over(nx, init_row, 0)

        def stage(k):
            stage_terms(rc_mode, shift, k)

            def pr_row(i, c):
                acc = zeros
                for j in range(nx):
                    acc = acc + P[i, j] * rdyn[k, j]
                Pr[k, i] = acc
                frp[i] = acc + p[i]
                for cc in range(nu):
                    pb = zeros
                    for j in range(nx):
                        pb = pb + P[i, j] * Bm[k, j, cc]
                    PB[i, cc] = pb
                return c

            over(nx, pr_row, 0)

            def guu_row(i, c):
                guu, gu = c
                brow = [Bm[k, i, cc] for cc in range(nu)]
                pbrow = [PB[i, cc] for cc in range(nu)]
                f = frp[i]
                guu = {cd: guu[cd] + brow[cd[0]] * pbrow[cd[1]] for cd in guu}
                gu = [gu[cc] + brow[cc] * f for cc in range(nu)]
                return guu, gu

            guu, gu = over(nx, guu_row, ({cd: zeros for cd in _tril(nu)}, [zeros] * nu))
            for cc in range(nu):
                guu[(cc, cc)] = guu[(cc, cc)] + rdiag[k, cc] + sgu[cc]
            gu = [gu[cc] + rh[cc] for cc in range(nu)]
            Lc = _chol(guu, nu)
            for n_, cd in enumerate(_tril(nu)):
                Lf[k, n_] = Lc[cd]
            z = _solve_lower(Lc, gu)
            kf = _solve_upper(Lc, z)
            for cc in range(nu):
                kff[k, cc] = -kf[cc]

            def gxu_row(i, c):
                # Gxu row i = (A' P B)[i], Y[:, i] = L^{-1} Gxu[i]',
                # K[:, i] = -L^{-T} Y[:, i], p_k[i] = gx[i] - Y[:, i]'z.
                gxu = [zeros] * nu
                gx = qh[i]
                for j in range(nx):
                    a = A[k, j, i]
                    gxu = [gxu[cc] + a * PB[j, cc] for cc in range(nu)]
                    gx = gx + a * frp[j]
                yi = _solve_lower(Lc, gxu)
                ki = _solve_upper(Lc, yi)
                pn = gx
                for cc in range(nu):
                    Y[k, cc, i] = yi[cc]
                    K[k, cc, i] = -ki[cc]
                    pn = pn - yi[cc] * z[cc]
                p[i] = pn
                return c

            over(nx, gxu_row, 0)

            def pa_entry(l_, j, c):
                acc = zeros
                for m in range(nx):
                    acc = acc + P[l_, m] * A[k, m, j]
                PA[l_, j] = acc
                return c

            over(nx, lambda l_, c: over(nx, lambda j, c: pa_entry(l_, j, c), c), 0)

            def p_entry(i, j, c):
                acc = jnp.where(i == j, qdiag[k, i] + sgx[i], zeros)
                for l_ in range(nx):
                    acc = acc + A[k, l_, i] * PA[l_, j]
                for cc in range(nu):
                    acc = acc - Y[k, cc, i] * Y[k, cc, j]
                P[i, j] = acc
                return c

            over(nx, lambda i, c: over(nx, lambda j, c: p_entry(i, j, c), c), 0)

        backward(stage)

    def sweep_vector(rc_mode, shift):
        """Corrector sweep: same KKT matrix as the affine predictor, so only the
        vector recursion runs, over the stored factors (factorize once)."""
        stage_terms(rc_mode, shift, T, with_u=False)

        def init_row(i, c):
            p[i] = qh[i]
            return c

        over(nx, init_row, 0)

        def stage(k):
            stage_terms(rc_mode, shift, k)

            def gu_row(i, gu):
                f = Pr[k, i] + p[i]
                frp[i] = f
                return [gu[cc] + Bm[k, i, cc] * f for cc in range(nu)]

            gu = over(nx, gu_row, [zeros] * nu)
            gu = [gu[cc] + rh[cc] for cc in range(nu)]
            Lc = {cd: Lf[k, n_] for n_, cd in enumerate(_tril(nu))}
            z = _solve_lower(Lc, gu)
            kf = _solve_upper(Lc, z)
            for cc in range(nu):
                kff[k, cc] = -kf[cc]

            def p_row(i, c):
                acc = qh[i]
                for j in range(nx):
                    acc = acc + A[k, j, i] * frp[j]
                for cc in range(nu):
                    acc = acc - Y[k, cc, i] * z[cc]
                p[i] = acc
                return c

            over(nx, p_row, 0)

        backward(stage)

    def rollout(rc_mode, shift, out_x, out_u, t):
        """Forward rollout of the Newton step into (out_x, out_u), folding the
        fraction-to-boundary limits of every variable into per-scenario
        (a_p, a_d)."""
        def lim(group, out):
            def body(k, i, a):
                b, rc = bound_rc(rc_mode, shift, group, k, i)
                return _step_limits(b, _directions(b, out[k, i], rc), t, *a)
            return body

        def zero_row(i, c):
            out_x[0, i] = zeros
            return c

        over(nx, zero_row, 0)

        def stage(k, a):
            def u_row(c_, c):
                acc = kff[k, c_]
                for i in range(nx):
                    acc = acc + K[k, c_, i] * out_x[k, i]
                out_u[k, c_] = acc
                return c

            over(nu, u_row, 0)

            def x_row(i, c):
                acc = rdyn[k, i]
                for j in range(nx):
                    acc = acc + A[k, i, j] * out_x[k, j]
                for cc in range(nu):
                    acc = acc + Bm[k, i, cc] * out_u[k, cc]
                out_x[k + 1, i] = acc
                return c

            over(nx, x_row, 0)
            return x_and_u(k, lim(x_group, out_x), lim(u_group, out_u), a)

        one = jnp.ones((S,), f32)
        a = fori(0, T, stage, (one, one))
        return over(nx, lambda i, a: lim(x_group, out_x)(T, i, a), a)

    def affine_gap(a_p, a_d):
        """Mean complementarity after the affine step (Mehrotra's predictor)."""
        def body(group, dref):
            def f(k, i, g):
                b = load(group, k, i)
                dirs = _directions(b, dref[k, i], _rc_affine(b))
                return g + _complementarity_after(b, dirs, a_p, a_d)
            return f

        return all_stages(body(x_group, ddxa), body(u_group, ddua), zeros) / m_total

    def update(rc_mode, shift, a_p, a_d):
        """Take the step; returns the new mean complementarity gap."""
        def body(group, dref, is_x):
            def f(k, i, g):
                b, rc = bound_rc(rc_mode, shift, group, k, i)
                d = dref[k, i]
                ds_l, ds_u, dl_l, dl_u, de_l, de_u = _directions(b, d, rc)
                nb = b._replace(
                    v=b.v + a_p * d,
                    sl=b.sl + a_p * ds_l, su=b.su + a_p * ds_u,
                    ll=b.ll + a_d * dl_l, lu=b.lu + a_d * dl_u,
                )
                if soft and is_x:
                    nb = nb._replace(el=b.el + a_p * de_l, eu=b.eu + a_p * de_u,
                                     nl=b.nl - a_d * dl_l, nu=b.nu - a_d * dl_u)
                group[0][k, i] = nb.v
                store(group, k, i, nb)
                return g + _complementarity(nb)
            return f

        g = all_stages(body(x_group, ddx, True), body(u_group, ddu, False), zeros)
        return g / m_total

    def ip_iteration(mu, gap):
        dynamics_residual()
        if o.mehrotra:
            # Affine predictor (per-scenario adaptive centering, HPIPM's scheme).
            sweep_matrix("affine", None)
            ap_a, ad_a = rollout("affine", None, ddxa, ddua, 1.0)
            gap_aff = affine_gap(ap_a, ad_a)
            ratio = gap_aff / jnp.maximum(gap, 1e-16)
            sig = jnp.minimum(jnp.maximum(ratio * ratio * ratio, 1e-4), 1.0)
            # Soft mode: f32 validity floor on the centering target — the exit
            # is per block, so a converged scenario keeps iterating while its
            # block-mates finish and must not center into the regime where f32
            # barrier weights break the Riccati (see boxqp.py).
            target = jnp.maximum(sig * gap, 1e-8 if soft else 1e-14)
            # Corrector: same KKT matrix -> vector-only sweep over the stored
            # factorization.
            sweep_vector("corrector", target)
            a_p, a_d = rollout("corrector", target, ddx, ddu, o.tau)
            new_gap = update("corrector", target, a_p, a_d)
        else:
            sweep_matrix("centered", mu)
            a_p, a_d = rollout("centered", mu, ddx, ddu, o.tau)
            new_gap = update("centered", mu, a_p, a_d)
        return jnp.maximum(o.sigma * new_gap, floor), new_gap

    def cond(carry):
        it, mu, _ = carry
        go = it < o.n_ip
        if o.adaptive_tol is not None:
            # Adaptive exit: stop once every scenario of the block is centered
            # below the tolerance. n_ip stays the hard cap.
            go = jnp.logical_and(go, jnp.max(mu) > o.adaptive_tol)
        return go

    def body(carry):
        it, mu, gap = carry
        mu, gap = ip_iteration(mu, gap)
        return it + 1, mu, gap

    mu0 = jnp.full((S,), o.mu0, f32)
    _, _, gap = jax.lax.while_loop(cond, body, (jnp.int32(0), mu0, gap0))
    gap_out[0] = gap


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_ip", "mu0", "sigma", "tau", "adaptive_tol", "mehrotra", "soft_rho",
        "interpret",
    ),
)
def solve_ocp_qp_lanes(
    qp: LanesQp,
    n_ip: int = 15,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    adaptive_tol: float | None = None,
    mehrotra: bool = False,
    soft_rho: float | None = None,
    interpret: bool = False,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Solve a batch of OCP-QPs, scenario axis last. Returns (dx (T+1,nx,B),
    du (T,nu,B), gap (B,) final complementarity gap per scenario).

    One launch over ceil(B / S) blocks of S = `SCENARIO_BLOCK` scenarios;
    the batch is padded to a whole block by repeating the last scenario, so
    padding never holds back a block's adaptive exit.
    mehrotra=True runs the predictor-corrector (two sweeps per iteration, one
    factorization); pair with adaptive_tol to bank the saved iterations.
    soft_rho: L1 penalty weight for soft state bounds (the bounded-multiplier
    formulation of ops/boxqp.py).
    """
    T, nx, _, B = qp.A.shape
    nu = qp.B.shape[2]
    f32 = jnp.float32
    S = SCENARIO_BLOCK
    B_pad = -(-B // S) * S

    if soft_rho is not None:
        # f32 validity floor: iterating the centering parameter below ~1e-8
        # drives active-bound barrier weights past what a float32 Riccati can
        # factor (see ops/boxqp.py gap_tol). The adaptive exit doubles as the
        # numerical stop.
        adaptive_tol = max(adaptive_tol or 0.0, 1e-8)
    opts = _Opts(n_ip, mu0, sigma, tau, adaptive_tol, mehrotra, soft_rho)

    def pad(x):
        x = x.astype(f32)
        if B_pad == B:
            return x
        return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, B_pad - B)], mode="edge")

    def spec(rows):
        return pl.BlockSpec((rows, S), lambda b: (0, b))

    def buf(*lead):
        return jax.ShapeDtypeStruct(lead + (B_pad,), f32)

    xs, us = (T + 1, nx), (T, nu)
    outs = [
        buf(*xs), buf(*us), buf(),  # dx, du, gap
        buf(*xs), buf(*xs), buf(*us), buf(*us),  # s_lx, s_ux, s_lu, s_uu
        buf(*xs), buf(*xs), buf(*us), buf(*us),  # lam_lx, lam_ux, lam_lu, lam_uu
        buf(T, nx), buf(T, nu, nx), buf(T, nu),  # r_dyn, K, kff
        buf(T, nx),  # Pr = P_{k+1} r_dyn_k
        buf(T, nu * (nu + 1) // 2),  # chol(Guu), packed lower triangle
        buf(T, nu, nx),  # Y = chol(Guu)^{-1} Gxu'
        buf(*xs), buf(*us),  # Newton direction (ddx, ddu)
        # Riccati work buffers of the current stage: P, p, P A, P B,
        # P r + p, qhat, sigma_x, rhat, sigma_u
        buf(nx, nx), buf(nx), buf(nx, nx), buf(nx, nu), buf(nx),
        buf(nx), buf(nx), buf(nu), buf(nu),
    ]
    if mehrotra:
        outs += [buf(*xs), buf(*us)]  # affine direction
    if soft_rho is not None:
        outs += [buf(*xs)] * 4  # e_lx, e_ux, nu_lx, nu_ux
    ins = [pad(a) for a in qp]
    leads = tuple(a.shape[:-1] for a in ins) + tuple(o.shape[:-1] for o in outs)
    flat_ins = [a.reshape(-1, B_pad) for a in ins]
    flat_outs = [
        jax.ShapeDtypeStruct((math.prod(o.shape[:-1]), B_pad), f32) for o in outs
    ]
    res = pl.pallas_call(
        functools.partial(_ip_kernel, opts, T, nx, nu, leads),
        grid=(B_pad // S,),
        in_specs=[spec(a.shape[0]) for a in flat_ins],
        out_specs=[spec(o.shape[0]) for o in flat_outs],
        out_shape=flat_outs,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="ocp_qp_ip",
    )(*flat_ins)
    dx, du, gap = (r.reshape(o.shape) for r, o in zip(res[:3], outs[:3]))
    return dx[..., :B], du[..., :B], gap[:B]
