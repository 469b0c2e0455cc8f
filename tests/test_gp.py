"""GP layer tests: closed-form posterior parity, masking invariance, FITC, training."""

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.gp.exact_gp import (
    GPData,
    GPHypers,
    fit_gp,
    init_hypers,
    marginal_log_likelihood,
    posterior,
    predict_mean,
    predict_var,
)
from gpmpc_tpu.gp.kernels import se_kernel
from gpmpc_tpu.gp.sparse import fitc_posterior_mean, select_inducing


def make_data(n=20, d=2, pad_to=32, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    X = np.zeros((pad_to, 3))
    Y = np.zeros(pad_to)
    m = np.zeros(pad_to)
    X[:n, :d] = x
    Y[:n] = y
    m[:n] = 1.0
    return (
        GPData(x=jnp.asarray(X, dtype), y=jnp.asarray(Y, dtype), mask=jnp.asarray(m, dtype)),
        x,
        y,
    )


def np_se(x1, x2, ell, sf2):
    d2 = ((x1[:, None, :] - x2[None, :, :]) / ell) ** 2
    return sf2 * np.exp(-0.5 * d2.sum(-1))


def test_posterior_matches_closed_form():
    data, x, y = make_data()
    h = GPHypers(
        raw_lengthscale=jnp.asarray(0.3, jnp.float64),
        raw_outputscale=jnp.asarray(0.5, jnp.float64),
        raw_noise=jnp.asarray(-1.0, jnp.float64),
    )
    ell, sf2, noise = float(h.lengthscale), float(h.outputscale), float(h.noise)
    post = posterior(h, data)
    z = np.array([[0.3, -0.2], [1.0, 0.5], [-1.5, 0.0]])
    zp = np.zeros((3, 3))
    zp[:, :2] = z
    mean = predict_mean(h, data, post, jnp.asarray(zp))
    var = predict_var(h, data, post, jnp.asarray(zp), include_noise=False)

    # The production Gram adds a 1e-6 * sf2 stability jitter; mirror it here.
    K = np_se(x, x, ell, sf2) + (noise + 1e-6 * sf2) * np.eye(len(x))
    Kzx = np_se(z, x, ell, sf2)
    mean_ref = Kzx @ np.linalg.solve(K, y)
    var_ref = sf2 - np.einsum("ij,ij->i", Kzx, np.linalg.solve(K, Kzx.T).T)
    np.testing.assert_allclose(np.asarray(mean), mean_ref, atol=1e-8)
    np.testing.assert_allclose(np.asarray(var), var_ref, atol=1e-8)


def test_padding_invariance():
    """MLL and posterior are identical for pad_to=32 and pad_to=64."""
    data_a, _, _ = make_data(pad_to=32)
    data_b, _, _ = make_data(pad_to=64)
    h = GPHypers(
        raw_lengthscale=jnp.asarray(0.1, jnp.float64),
        raw_outputscale=jnp.asarray(0.2, jnp.float64),
        raw_noise=jnp.asarray(-0.5, jnp.float64),
    )
    mll_a = marginal_log_likelihood(h, data_a)
    mll_b = marginal_log_likelihood(h, data_b)
    np.testing.assert_allclose(float(mll_a), float(mll_b), rtol=1e-10)
    z = jnp.asarray(np.random.default_rng(1).normal(size=(5, 3)))
    pa, pb = posterior(h, data_a), posterior(h, data_b)
    np.testing.assert_allclose(
        np.asarray(predict_mean(h, data_a, pa, z)),
        np.asarray(predict_mean(h, data_b, pb, z)),
        atol=1e-10,
    )


def test_fit_gp_learns_signal():
    """Training improves the MLL and the fitted GP interpolates the data."""
    data, x, y = make_data(n=24, seed=3)
    h0 = init_hypers(jnp.float64)
    mll0 = marginal_log_likelihood(h0, data)
    h, loss = fit_gp(data, n_train=300, lr=0.05)
    mll1 = marginal_log_likelihood(h, data)
    assert float(mll1) > float(mll0)
    post = posterior(h, data)
    pred = predict_mean(h, data, post, data.x[:24])
    resid = np.asarray(pred) - y
    assert np.sqrt(np.mean(resid**2)) < 0.2


def test_fit_gp_batched_vmap():
    datas = [make_data(seed=s)[0] for s in range(3)]
    batch = jax.tree.map(lambda *a: jnp.stack(a), *datas)
    hypers, losses = jax.vmap(lambda d: fit_gp(d, n_train=50, lr=0.05))(batch)
    h_single, loss_single = fit_gp(datas[1], n_train=50, lr=0.05)
    np.testing.assert_allclose(
        float(hypers.raw_lengthscale[1]), float(h_single.raw_lengthscale), rtol=1e-5
    )


def test_fitc_matches_exact_when_all_inducing():
    """FITC with the full active set as inducing points reproduces the exact mean."""
    data, x, y = make_data(n=15, pad_to=24)
    h = GPHypers(
        raw_lengthscale=jnp.asarray(0.4, jnp.float64),
        raw_outputscale=jnp.asarray(0.3, jnp.float64),
        raw_noise=jnp.asarray(-1.0, jnp.float64),
    )
    idx, s_mask = select_inducing(jax.random.PRNGKey(0), data.mask, 15)
    Zs, alpha = fitc_posterior_mean(h, data, idx, s_mask)
    z = np.zeros((4, 3))
    z[:, :2] = np.random.default_rng(2).normal(size=(4, 2))
    mean_fitc = se_kernel(jnp.asarray(z), Zs, h.lengthscale, h.outputscale) @ alpha

    post = posterior(h, data)
    mean_exact = predict_mean(h, data, post, jnp.asarray(z))
    # 1e-6 jitter on K_ss bounds the agreement at ~1e-5
    np.testing.assert_allclose(np.asarray(mean_fitc), np.asarray(mean_exact), atol=1e-4)


def test_fitc_variance_matches_exact_when_all_inducing():
    """With the full active set as inducing points, the FITC variance form
    reproduces the exact posterior variance (and stays in [0, sf2])."""
    from gpmpc_tpu.gp.exact_gp import predict_var
    from gpmpc_tpu.gp.sparse import fitc_posterior

    data, x, y = make_data(n=15, pad_to=24)
    h = GPHypers(
        raw_lengthscale=jnp.asarray(0.4, jnp.float64),
        raw_outputscale=jnp.asarray(0.3, jnp.float64),
        raw_noise=jnp.asarray(-1.0, jnp.float64),
    )
    idx, s_mask = select_inducing(jax.random.PRNGKey(0), data.mask, 15)
    Zs, _, W = fitc_posterior(h, data, idx, s_mask)
    z = np.zeros((6, 3))
    z[:, :2] = np.random.default_rng(3).normal(size=(6, 2))
    k = se_kernel(jnp.asarray(z), Zs, h.lengthscale, h.outputscale) * s_mask[None, :]
    var_fitc = h.outputscale - jnp.einsum("nm,mk,nk->n", k, W, k)

    post = posterior(h, data)
    var_exact = predict_var(h, data, post, jnp.asarray(z), include_noise=False)
    np.testing.assert_allclose(np.asarray(var_fitc), np.asarray(var_exact), atol=1e-4)
    assert np.all(np.asarray(var_fitc) > 0)
    assert np.all(np.asarray(var_fitc) <= float(h.outputscale) + 1e-6)


def test_fitc_variance_subset_is_conservative_approx():
    """With a strict inducing subset the FITC variance stays positive, bounded
    by sf2, and close to the exact variance at the inducing points themselves."""
    from gpmpc_tpu.gp.sparse import fitc_posterior

    data, x, y = make_data(n=20, pad_to=32)
    h = GPHypers(
        raw_lengthscale=jnp.asarray(0.5, jnp.float64),
        raw_outputscale=jnp.asarray(0.2, jnp.float64),
        raw_noise=jnp.asarray(-1.5, jnp.float64),
    )
    idx, s_mask = select_inducing(jax.random.PRNGKey(2), data.mask, 10)
    Zs, _, W = fitc_posterior(h, data, idx, s_mask)
    rng = np.random.default_rng(5)
    z = np.zeros((8, 3))
    z[:, :2] = rng.normal(size=(8, 2))
    k = se_kernel(jnp.asarray(z), Zs, h.lengthscale, h.outputscale) * s_mask[None, :]
    var = np.asarray(h.outputscale - jnp.einsum("nm,mk,nk->n", k, W, k))
    assert np.all(var > 0) and np.all(var <= float(h.outputscale) + 1e-6)


def test_select_inducing_subset_of_active():
    mask = jnp.asarray(np.r_[np.ones(10), np.zeros(22)])
    idx, s_mask = select_inducing(jax.random.PRNGKey(1), mask, 8)
    assert np.all(np.asarray(idx) < 10)
    assert float(jnp.sum(s_mask)) == 8
    # fewer active than requested
    idx2, s_mask2 = select_inducing(jax.random.PRNGKey(1), mask, 16)
    assert float(jnp.sum(s_mask2)) == 10
    assert np.all(np.sort(np.asarray(idx2[:10])) == np.arange(10))


def test_ard_hypers_fit_and_predict():
    """ARD (per-dimension) lengthscales: fit runs, padded dims stay inert, and
    anisotropic data yields anisotropic lengthscales."""
    rng = np.random.default_rng(5)
    n, pad_to = 30, 32
    x = rng.normal(size=(n, 2))
    # target depends strongly on dim 0, weakly on dim 1
    y = np.sin(2.0 * x[:, 0]) + 0.05 * x[:, 1] + 0.05 * rng.normal(size=n)
    X = np.zeros((pad_to, 3)); X[:n, :2] = x
    Y = np.zeros(pad_to); Y[:n] = y
    m = np.zeros(pad_to); m[:n] = 1.0
    data = GPData(x=jnp.asarray(X), y=jnp.asarray(Y), mask=jnp.asarray(m))

    h0 = init_hypers(jnp.float64, ard_dims=3)
    h, _ = fit_gp(data, hypers=h0, n_train=200, lr=0.05)
    ell = np.asarray(jax.nn.softplus(h.raw_lengthscale))
    assert ell.shape == (3,)
    # padded dim got no gradient -> still at the softplus(0) init
    np.testing.assert_allclose(ell[2], np.log(2.0), atol=1e-6)  # softplus(0)
    # strong dimension gets the shorter lengthscale
    assert ell[0] < ell[1]
    post = posterior(h, data)
    pred = predict_mean(h, data, post, data.x[:n])
    assert np.sqrt(np.mean((np.asarray(pred) - y) ** 2)) < 0.2


def test_compat_surface_matches_reference_semantics():
    """The reference-API shim (gp/compat.py): covSE kernels, GaussianProcess
    construct->fit->predict, K/K_inv caches."""
    from gpmpc_tpu.gp.compat import GaussianProcess as CompatGP
    from gpmpc_tpu.gp.compat import covSE_single, covSE_vectorized
    from gpmpc_tpu.gp.compat import fit_gp as compat_fit

    rng = np.random.default_rng(0)
    x = rng.normal(size=(15, 2)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)

    gp = CompatGP(x, y)
    assert gp.n_ind_points == 15 and gp.input_dimension == 2
    compat_fit(gp, n_train=150, lr=0.05)
    assert gp.K.shape == (15, 15) and gp.K_inv is not None
    mean, var = gp.predict(x[:5], include_noise=False)
    assert np.sqrt(np.mean((mean - y[:5]) ** 2)) < 0.25
    assert np.all(var >= 0)

    # kernels: covSE_single uses the (d, n) CasADi column convention
    k1 = np.asarray(covSE_single(x[0], x[:6].T, 1.0, 2.0))
    k2 = np.asarray(covSE_vectorized(x[0], x[:6], 1.0, 2.0))
    np.testing.assert_allclose(k1, k2, atol=1e-6)
    assert k1[0] == np.float32(2.0)  # k(x, x) = sf2


def test_overtrained_fit_recovers_instead_of_raising():
    """Round-4 verdict item 3: long Adam runs (the config default is
    iterations=500) over-train the likelihood noise toward zero until the f32
    Gram loses positive-definiteness; through round 4 this crashed
    select_action. The jitter escalation (`_robust_cholesky`) must keep the
    fit, the posterior, and predictions finite instead."""
    from gpmpc_tpu.gp.exact_gp import (
        GPHypers, _masked_gram, _robust_cholesky, posterior, predict_mean,
        predict_var,
    )

    rng = np.random.default_rng(0)
    # Exactly-duplicated inputs + a hyper state in the over-trained regime
    # (noise driven to ~2e-9, far below where a rank-deficient Gram is safe).
    # Note the PLAIN factorization survives this on CPU LAPACK (its pivot
    # errors are locally, not globally, bounded) — the historical crash
    # reproduced on the real twolink residual dataset (CPU) and under
    # reduced-precision (bf16) matmuls. The end-to-end regression coverage is the
    # twolink learning-loop test at the config-default iterations=500
    # (tests/test_learning_loop.py); this unit test pins the recovery
    # properties of the escalation path itself.
    x = np.repeat(rng.normal(size=(30, 3)).astype(np.float32), 8, axis=0)
    y = np.sin(x[:, 0]).astype(np.float32)
    data = GPData(
        x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.ones(x.shape[0], jnp.float32)
    )
    bad = GPHypers(
        raw_lengthscale=jnp.asarray(0.0, jnp.float32),
        raw_outputscale=jnp.asarray(0.0, jnp.float32),
        raw_noise=jnp.asarray(-20.0, jnp.float32),
    )
    chol = _robust_cholesky(data, bad)
    assert bool(jnp.all(jnp.isfinite(chol)))
    # Escalation levels change nothing when the plain factorization is clean.
    clean = GPHypers(
        raw_lengthscale=jnp.asarray(0.0, jnp.float32),
        raw_outputscale=jnp.asarray(0.0, jnp.float32),
        raw_noise=jnp.asarray(0.0, jnp.float32),
    )
    np.testing.assert_array_equal(
        np.asarray(_robust_cholesky(data, clean)),
        np.asarray(jnp.linalg.cholesky(_masked_gram(data, clean))),
    )

    # The full fit from the poisoned state stays finite and usable.
    hypers, loss = fit_gp(data, hypers=bad, n_train=100, lr=0.05)
    assert np.isfinite(float(loss))
    post = posterior(hypers, data)
    mu = predict_mean(hypers, data, post, jnp.asarray(x[:5]))
    var = predict_var(hypers, data, post, jnp.asarray(x[:5]))
    assert np.all(np.isfinite(np.asarray(mu)))
    assert np.all(np.isfinite(np.asarray(var)))

    # And a long fit from the default init on the same degenerate dataset
    # (the over-training trajectory itself) stays finite end to end.
    hypers2, loss2 = fit_gp(data, n_train=500, lr=0.05)
    assert np.isfinite(float(loss2))
    assert np.all(np.isfinite(np.asarray(posterior(hypers2, data).alpha)))
