"""The XLA stages of the GPU step, each against an independent numpy reference.

On a GPU the step runs its QPs in the Pallas kernel (tests/test_pallas_ocp*.py)
and everything else under XLA: the GP posterior variance (a quadratic-form
GEMM), the chance-constraint covariance recursion (a vmapped scan) and the
dynamics linearization (vmapped jacfwd). These tests pin each of them to a
plain reference: the closed-form exact-GP variance, a numpy loop of the
covariance recursion, and central finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpmpc_tpu.control import gpmpc as gpmpc_mod
from gpmpc_tpu.control.gpmpc import GpModel, GpMpcConsts
from gpmpc_tpu.gp.exact_gp import GPHypers
from gpmpc_tpu.models.residual import QUADROTOR_SPEC


def _inv_softplus(v):
    return np.log(np.expm1(np.asarray(v, np.float64)))


def _se(x1, x2, ell, sf2):
    d = (x1[:, None, :] - x2[None, :, :]) / ell
    return sf2 * np.exp(-0.5 * np.sum(d * d, axis=-1))


@pytest.mark.parametrize("ard", [False, True], ids=["isotropic", "ard"])
def test_batched_variance_matches_closed_form(ard):
    """batched_variances (the quadratic form k W k' with W = (K + s2 I)^-1)
    == sf2 - k (K + s2 I)^-1 k', the exact-GP posterior variance."""
    G, M, D, B, T = 3, 20, 3, 4, 6
    rng = np.random.default_rng(0)
    Z = rng.normal(0, 1.0, (G, M, D))
    mask = np.ones((G, M))
    mask[:, -3:] = 0.0  # padded rows contribute nothing
    ell = rng.uniform(0.6, 1.5, (G, D)) if ard else rng.uniform(0.6, 1.5, (G,))
    sf2 = rng.uniform(0.5, 2.0, (G,))
    noise = np.full((G,), 0.1)
    W = np.zeros((G, M, M))
    for g in range(G):
        K = _se(Z[g], Z[g], ell[g], sf2[g]) * np.outer(mask[g], mask[g])
        W[g] = np.linalg.inv(K + noise[g] * np.eye(M))
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    hypers = GPHypers(
        raw_lengthscale=f32(_inv_softplus(ell)),
        raw_outputscale=f32(_inv_softplus(sf2)),
        raw_noise=f32(_inv_softplus(noise)),
    )
    gp = GpModel(
        Z=f32(Z), y=f32(np.zeros((G, M))), mask=f32(mask), hypers=hypers,
        Zs=f32(Z), alpha_s=f32(np.zeros((G, M))),
        var_Z=f32(Z), var_mat=f32(W), var_mask=f32(mask), trained=jnp.asarray(True),
    )
    zq = rng.normal(0, 1.0, (G, B, T, D))
    got = np.asarray(jax.jit(gpmpc_mod.batched_variances)(gp, f32(zq)))
    assert got.shape == (G, B, T)
    for g in range(G):
        z = zq[g].reshape(-1, D)
        k = _se(z, Z[g], ell[g], sf2[g]) * mask[g][None]
        Kfull = _se(Z[g], Z[g], ell[g], sf2[g]) * np.outer(mask[g], mask[g])
        want = sf2[g] - np.einsum(
            "ij,ji->i", k, np.linalg.solve(Kfull + noise[g] * np.eye(M), k.T)
        )
        np.testing.assert_allclose(got[g].reshape(-1), want, rtol=1e-4, atol=2e-5)


def test_tightening_scan_matches_numpy_recursion():
    """The vmapped covariance-propagation scan == a numpy loop of
    Sigma_{k+1} = (A + B K) Sigma_k (A + B K)' + Bd diag(d_k) Bd' with
    t_x = ppf sqrt(diag Sigma_k), t_u = ppf sqrt(diag K Sigma_k K')."""
    nx, nu, T, Bn = 12, 4, 7, 3
    rng = np.random.default_rng(1)
    A = np.eye(nx) + 0.05 * rng.normal(size=(nx, nx))
    Bm = 0.1 * rng.normal(size=(nx, nu))
    K = 0.2 * rng.normal(size=(nu, nx))
    Bd = np.eye(nx)[:, list(QUADROTOR_SPEC.uncertain_dim)]
    ppf, dt = 1.7, 0.02
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    consts = GpMpcConsts(
        mpc=None, Ad=f32(A), Bd_in=f32(Bm), lqr_gain=f32(K), Bd=f32(Bd),
        inverse_cdf=f32(ppf), dt=f32(dt),
    )
    noise = np.array([0.05, 0.02, 0.03])
    gp = GpModel(*([None] * 3), GPHypers(None, None, f32(_inv_softplus(noise))),
                 *([None] * 6))
    zq = rng.normal(0, 0.3, (Bn, T, QUADROTOR_SPEC.z_dim))
    covs = rng.uniform(0.01, 0.5, (Bn, QUADROTOR_SPEC.num_gps, T))
    t_x, t_u = jax.jit(jax.vmap(
        lambda z, c: gpmpc_mod.tightening_from_variances(consts, gp, z, c)
    ))(f32(zq), f32(covs))
    for b in range(Bn):
        F = np.asarray(QUADROTOR_SPEC.var_factors(jnp.asarray(zq[b])), np.float64)
        d = (np.einsum("tdg,gt->td", F, covs[b]) + F @ noise) * dt**2
        cov = np.zeros((nx, nx))
        want_x, want_u = [], []
        for k in range(T):
            want_x.append(ppf * np.sqrt(np.maximum(np.diag(cov), 0)))
            want_u.append(ppf * np.sqrt(np.maximum(np.diag(K @ cov @ K.T), 0)))
            Acl = A + Bm @ K
            cov = Acl @ cov @ Acl.T + Bd @ np.diag(d[k]) @ Bd.T
        want_x.append(ppf * np.sqrt(np.maximum(np.diag(cov), 0)))
        np.testing.assert_allclose(np.asarray(t_x[b]), np.stack(want_x), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(np.asarray(t_u[b]), np.stack(want_u), rtol=1e-4, atol=1e-7)


def _family(name):
    from gpmpc_tpu.utils import benchkit

    if name == "quadrotor":
        from gpmpc_tpu.models.symbolic import symbolic_attitude

        model = symbolic_attitude(dt=0.02, params=benchkit.reference_prior_dict())
        gp = benchkit.synthetic_gp_model(max_points=32, max_inducing=10, n_data=24, n_train=5)
        x0 = np.zeros(12)
        u0 = np.asarray(model.u_eq if model.u_eq is not None else [0.3234, 0, 0, 0])
    elif name == "cartpole":
        from gpmpc_tpu.models import cartpole

        model = cartpole.symbolic_cartpole(dt=0.02)
        gp = benchkit.synthetic_cartpole_gp_model(
            max_points=32, max_inducing=10, n_data=24, n_train=5
        )
        x0, u0 = np.zeros(4), np.zeros(1)
    else:
        from gpmpc_tpu.models import twolink

        model = twolink.symbolic_twolink(dt=0.02)
        gp = benchkit.synthetic_twolink_gp_model(
            max_points=32, max_inducing=10, n_data=24, n_train=5
        )
        x0, u0 = np.asarray(model.x_eq, np.float64), np.asarray(model.u_eq, np.float64)
    return model, gp, x0, u0


@pytest.mark.parametrize("family", ["quadrotor", "cartpole", "twolink"])
def test_jacfwd_linearization_matches_finite_differences(family):
    """The GP-augmented discrete dynamics' jacfwd Jacobians (what the kernel
    path feeds the QP) == central finite differences, in float64."""
    model, gp, x0, u0 = _family(family)
    fd = lambda x, u: gpmpc_mod.augmented_fd(model, gp, x, u)  # noqa: E731
    rng = np.random.default_rng(2)
    x = jnp.asarray(x0 + 0.05 * rng.normal(size=x0.shape), jnp.float64)
    u = jnp.asarray(u0 + 0.05 * rng.normal(size=u0.shape), jnp.float64)
    A, Bm = jax.jit(jax.jacfwd(fd, argnums=(0, 1)))(x, u)
    f = jax.jit(fd)
    eps = 1e-6
    A_fd = np.stack([
        (np.asarray(f(x + eps * e, u)) - np.asarray(f(x - eps * e, u))) / (2 * eps)
        for e in np.eye(x.shape[0])
    ], axis=1)
    B_fd = np.stack([
        (np.asarray(f(x, u + eps * e)) - np.asarray(f(x, u - eps * e))) / (2 * eps)
        for e in np.eye(u.shape[0])
    ], axis=1)
    np.testing.assert_allclose(np.asarray(A), A_fd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(Bm), B_fd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("linearizer", ["jacfwd", "analytic", "population"])
def test_kernel_path_matmuls_at_full_precision(linearizer):
    """Every matmul of the kernel-path step (variance, tightening,
    linearization, KKT residuals) is lowered at HIGHEST precision: on a GPU
    the default would round f32 operands to TF32, which a GP trained to its
    noise floor turns into NaN solves. One case per linearizer."""
    from gpmpc_tpu.parallel.batch import batched_gpmpc_step
    from gpmpc_tpu.utils import parity
    from gpmpc_tpu.utils.benchkit import build_problem

    B = 2
    problem = build_problem("quadrotor", horizon=3, gp_points=16, gp_inducing=8, n_train=2)
    cfg = problem.ctrl.cfg._replace(analytic_jac=linearizer == "analytic")
    gp = problem.gp
    if linearizer == "population":
        gp = jax.tree.map(lambda a: jnp.stack([a] * B), gp)
    _, states, obs = parity.initial_states(problem, B)
    step = lambda c, g, s, o: batched_gpmpc_step(  # noqa: E731
        problem.model, cfg, c, g, s, o, backend="lanes", interpret=True
    )
    text = jax.jit(step).lower(problem.ctrl.consts, gp, states, obs).as_text()
    dots = [line for line in text.splitlines() if "stablehlo.dot_general" in line]
    assert dots
    assert all("precision = [HIGHEST, HIGHEST]" in line for line in dots), [
        line.strip() for line in dots if "HIGHEST" not in line
    ][:3]


@pytest.mark.parametrize("soft_rho", [None, 50.0], ids=["hard", "soft"])
def test_qp_parity_harness(soft_rho):
    """The QP parity harness chip_smoke.py runs at full width, here at a tiny
    one with the kernel in interpret mode: a linearized quadrotor step's QPs
    agree with boxqp within the stated bar."""
    from gpmpc_tpu.utils import parity
    from gpmpc_tpu.utils.benchkit import build_problem

    problem = build_problem("quadrotor", horizon=5, gp_points=16, gp_inducing=8, n_train=2)
    cfg = problem.ctrl.cfg
    qp = parity.step_qp(problem, 8, soft_rho)
    assert qp.A.shape == (5, 12, 12, 8)
    res = parity.qp_parity(qp, cfg, soft_rho, interpret=True)
    assert parity.qp_parity_ok(res, soft_rho is not None, cfg.qp_mehrotra), res
