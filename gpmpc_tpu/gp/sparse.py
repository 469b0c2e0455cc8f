"""FITC sparse-GP posterior mean for embedding in the MPC dynamics.

≙ GPMPC.precompute_sparse_posterior_mean, /root/reference/gpmpc/gpmpc.py:377-400:
pick `n_samples` random training points as inducing points and compute FITC weights

    Gamma     = diag(K + sigma^2 I - K_xs K_ss^-1 K_xs')
    Sigma_inv = K_ss + K_xs' Gamma^-1 K_xs
    alpha     = Sigma_inv^-1 K_xs' Gamma^-1 y

so the in-dynamics mean is k(z, Zs) @ alpha (gpmpc.py:185-187). Implemented with
padded fixed shapes: the inducing set always has capacity `Ms`; when fewer active
training points exist, the selection mask covers them all (the reference instead
re-codegens its solver for every new `n_samples`, gpmpc.py:213-218).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpmpc_tpu.gp.exact_gp import GPData, GPHypers
from gpmpc_tpu.gp.kernels import se_kernel


def select_inducing(
    key: jax.Array, mask: jax.Array, n_inducing: int
) -> tuple[jax.Array, jax.Array]:
    """Uniform-without-replacement choice of up to `n_inducing` active rows.

    ≙ np_random.choice(..., replace=False) at gpmpc.py:387. Returns (idx, s_mask):
    idx (Ms,) row indices into the padded buffer, s_mask (Ms,) activity mask.
    """
    m = mask.shape[0]
    # Random scores; inactive rows pushed to the bottom -> top-k picks active rows
    # uniformly at random without replacement (Gumbel-top-k on uniform weights).
    scores = jax.random.uniform(key, (m,)) + jnp.where(mask > 0, 0.0, -1e9)
    _, idx = jax.lax.top_k(scores, n_inducing)
    n_active = jnp.sum(mask).astype(jnp.int32)
    s_mask = (jnp.arange(n_inducing) < jnp.minimum(n_active, n_inducing)).astype(mask.dtype)
    return idx, s_mask


def fitc_posterior_mean(
    hypers: GPHypers,
    data: GPData,
    idx: jax.Array,
    s_mask: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """FITC mean weights only — see `fitc_posterior` for mean + variance."""
    Zs, alpha, _ = fitc_posterior(hypers, data, idx, s_mask)
    return Zs, alpha


def fitc_posterior(
    hypers: GPHypers,
    data: GPData,
    idx: jax.Array,
    s_mask: jax.Array,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """FITC posterior on the inducing subset `data.x[idx]`.

    Returns (Zs, alpha, W): Zs (Ms, D) inducing inputs (padded rows zero),
    alpha (Ms,) mean weights with padded entries zero, and W (Ms, Ms) the PSD
    variance quadratic form such that

        mean(z) = k(z, Zs) @ alpha
        var(z)  = sf2 - k(z, Zs) @ W @ k(z, Zs)'     (FITC predictive variance)

    with W = K_ss^-1 - (K_ss + K_xs' Gamma^-1 K_xs)^-1. This makes the
    large-dataset variance an O(Ms^2)-per-query quadratic form — the same shape
    as the exact K_inv form, so both share one batched variance GEMM
    (control/gpmpc.py::gp_variances). It is the principled inducing-point analogue of the
    reference's LOVE-approximated `fast_pred_var` tightening variance
    (/root/reference/gpmpc/gpmpc.py:8,443-445): both trade an O(N^2) exact form
    for a low-rank one computed at train time.
    """
    # Train-time factorization off the control hot path: pin full-precision
    # matmuls (accelerator f32 matmuls may default to TF32 or bf16 passes; the
    # near-rank-1 K_ss factorizations here are exactly the conditioning regime
    # that loses positive-definiteness at reduced precision — same class as the
    # Riccati and 500-iteration-fit NaNs noted in riccati.py and
    # exact_gp.fit_gp).
    with jax.default_matmul_precision("highest"):
        return _fitc_posterior_highest(hypers, data, idx, s_mask)


def _fitc_posterior_highest(hypers, data, idx, s_mask):
    Zs = data.x[idx] * s_mask[:, None]
    ell, sf2, noise = hypers.lengthscale, hypers.outputscale, hypers.noise
    m = Zs.shape[0]

    # Near-duplicate inducing inputs (e.g. the thrust GP, whose 1-d inputs cluster
    # around hover) make K_ss nearly rank-1, so the naive normal-equations form of
    # FITC (gpmpc.py:392-397) is numerically explosive in float32. We use the
    # standard stable reformulation: with L = chol(K_ss), A = L^-1 K_xs' Gamma^-1/2,
    #   Sigma_inv = L (I + A A') L',  alpha = L^-T (I + A A')^-1 A (y / sqrt(Gamma)).
    K_ss = se_kernel(Zs, Zs, ell, sf2) * (s_mask[:, None] * s_mask[None, :])
    jitter = 1e-5 * sf2 + 1e-6
    K_ss = K_ss + jnp.diag(jitter * s_mask + (1.0 - s_mask))
    K_xs = se_kernel(data.x, Zs, ell, sf2) * (data.mask[:, None] * s_mask[None, :])

    chol_ss = jnp.linalg.cholesky(K_ss)
    V = jax.scipy.linalg.solve_triangular(chol_ss, K_xs.T, lower=True)  # (m, N)
    # Gamma = diag(K(X,X) + sigma^2 I - Q_ff); the reference takes diag(gp.K - ...)
    # where gp.K includes the noise term (gp.py:45). Exact arithmetic guarantees
    # Gamma >= sigma^2, which we use as the numerical floor.
    k_diag = (sf2 + noise) * data.mask + (1.0 - data.mask)
    Gamma = jnp.maximum(k_diag - jnp.sum(V * V, axis=0), noise)

    inv_sqrt_gamma = jax.lax.rsqrt(Gamma) * data.mask
    A = V * inv_sqrt_gamma[None, :]  # (m, N)
    B = jnp.eye(m, dtype=Zs.dtype) + A @ A.T
    chol_B = jnp.linalg.cholesky(B)
    c = A @ (data.y * inv_sqrt_gamma)
    w = jax.scipy.linalg.cho_solve((chol_B, True), c)
    alpha = jax.scipy.linalg.solve_triangular(chol_ss, w, lower=True, trans=1)

    # Variance quadratic form W = K_ss^-1 - Sigma, with Sigma = L^-T B^-1 L^-1:
    # W = L^-T (I - B^-1) L^-1, computed from the same two Cholesky factors.
    eye = jnp.eye(m, dtype=Zs.dtype)
    L_inv = jax.scipy.linalg.solve_triangular(chol_ss, eye, lower=True)  # (m, m)
    B_inv = jax.scipy.linalg.cho_solve((chol_B, True), eye)
    W = L_inv.T @ (eye - B_inv) @ L_inv
    W = 0.5 * (W + W.T) * (s_mask[:, None] * s_mask[None, :])
    return Zs, alpha * s_mask, W
