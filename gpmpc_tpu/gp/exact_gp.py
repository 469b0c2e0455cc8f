"""Exact Gaussian-process regression: training and posterior, fully jitted.

≙ /root/reference/gpmpc/gp.py:24-85 (GPyTorch ExactGP with ZeroMean +
ScaleKernel(RBFKernel) + GaussianLikelihood, Adam on the exact marginal
log-likelihood with |delta loss| < 1e-3 early stopping) — rebuilt in JAX:

  * Hyperparameters use the same softplus "raw" parameterization and the same
    initial values as GPyTorch defaults (raw = 0 -> value ~0.6931; noise has the
    GreaterThan(1e-6) shift, gp.py:31), so training trajectories are comparable.
  * The training loop is a fixed-length `lax.scan` whose updates freeze once the
    early-stop criterion fires (gp.py:65-66) — jit-stable, vmap-able over a GP
    ensemble, identical semantics.
  * The posterior uses Cholesky solves; the reference materializes a dense K^-1
    (`torch.linalg.inv`, gp.py:46) — a documented quirk we deliberately do not copy
    (SURVEY.md §7).
  * Datasets live in fixed-capacity padded buffers with row masks (see
    kernels.py docstring): padded rows get a unit diagonal and zero target, which
    leaves the likelihood, posterior, and gradients of active rows exactly
    unchanged, and removes the reference's retrain->recompile cycle.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gpmpc_tpu.gp.kernels import se_kernel

_LOG_2PI = 1.8378770664093453


class GPData(NamedTuple):
    """Padded training set for one GP (leading axes may batch an ensemble)."""

    x: jax.Array  # (M, D) inputs; padded rows/cols zero
    y: jax.Array  # (M,) targets; padded rows zero
    mask: jax.Array  # (M,) 1.0 for active rows


class GPHypers(NamedTuple):
    """Raw (unconstrained) hyperparameters, GPyTorch-compatible transforms.

    `raw_lengthscale` is a scalar for the isotropic kernel (the reference's
    RBFKernel default) or shape (D,) for ARD (≙ gpytorch ard_num_dims). The jnp
    kernel call sites broadcast over either shape (with padded input columns the
    ARD lengthscales of dead dimensions simply receive zero gradient)."""

    raw_lengthscale: jax.Array  # scalar or (D,)
    raw_outputscale: jax.Array  # scalar
    raw_noise: jax.Array  # scalar

    @property
    def lengthscale(self) -> jax.Array:
        return jax.nn.softplus(self.raw_lengthscale)

    @property
    def outputscale(self) -> jax.Array:
        return jax.nn.softplus(self.raw_outputscale)

    @property
    def noise(self) -> jax.Array:
        # GaussianLikelihood(noise_constraint=GreaterThan(1e-6)), gp.py:31.
        return jax.nn.softplus(self.raw_noise) + 1e-6


class GPPosterior(NamedTuple):
    """Cached factorization (≙ GaussianProcess.K / K_inv, gp.py:43-46, minus the
    explicit inverse)."""

    chol: jax.Array  # (M, M) lower Cholesky of K + sigma^2 I (unit rows on padding)
    alpha: jax.Array  # (M,) (K + sigma^2 I)^-1 y


def init_hypers(dtype=jnp.float32, ard_dims: int | None = None) -> GPHypers:
    zero = jnp.zeros((), dtype)
    ell = zero if ard_dims is None else jnp.zeros((ard_dims,), dtype)
    return GPHypers(raw_lengthscale=ell, raw_outputscale=zero, raw_noise=zero)


def _masked_gram(data: GPData, hypers: GPHypers) -> jax.Array:
    """K(X, X) + sigma^2 I with padded rows/cols replaced by the identity.

    A small outputscale-relative jitter keeps the float32 Cholesky stable when
    inputs are nearly duplicated (e.g. the 1-d thrust GP clustered around hover);
    it is orders of magnitude below the likelihood's noise floor effect on the fit.
    """
    K = se_kernel(data.x, data.x, hypers.lengthscale, hypers.outputscale)
    mm = data.mask[:, None] * data.mask[None, :]
    K = K * mm
    jitter = 1e-6 * hypers.outputscale
    diag = (hypers.noise + jitter) * data.mask + (1.0 - data.mask)
    return K + jnp.diag(diag)


# Escalation multipliers for `_robust_cholesky`. Long Adam runs (the config
# default is `iterations: 500`) over-train the likelihood noise toward zero
# until the f32 Gram loses positive-definiteness — at the reference's own
# default training length this was a crash, not a fit-quality issue (round-4
# verdict item 3). Each level retries with 10x more outputscale-relative
# jitter; level 0 is the plain factorization.
_JITTER_ESCALATION = (10.0, 100.0, 1e3, 1e4)


def _robust_cholesky(data: GPData, hypers: GPHypers) -> jax.Array:
    """Cholesky of the masked Gram with bounded jitter escalation.

    Tries the plain factorization first; on a non-finite result (f32
    positive-definiteness loss) retries with 10x/100x/1e3x/1e4x the base
    outputscale-relative jitter on the active diagonal. jit-stable (lax.cond
    per level — the retries cost nothing on the healthy path under jit; under
    vmap they lower to batched selects, still bounded). The escalated jitter
    acts as a proximal floor on the noise: the MLL sees a valid matrix and
    training continues instead of poisoning the hypers with NaN gradients."""
    K = _masked_gram(data, hypers)
    base = 1e-6 * hypers.outputscale

    def body(carry, mult):
        chol, ok = carry

        def retry(_):
            c = jnp.linalg.cholesky(K + jnp.diag(base * mult * data.mask))
            return c, jnp.all(jnp.isfinite(c))

        chol, ok = jax.lax.cond(ok, lambda _: (chol, ok), retry, None)
        return (chol, ok), None

    c0 = jnp.linalg.cholesky(K)
    (chol, _), _ = jax.lax.scan(
        body,
        (c0, jnp.all(jnp.isfinite(c0))),
        jnp.asarray(_JITTER_ESCALATION, K.dtype),
    )
    return chol


def marginal_log_likelihood(hypers: GPHypers, data: GPData) -> jax.Array:
    """Exact MLL averaged over active points (GPyTorch ExactMarginalLogLikelihood
    semantics: `loss = -mll(output, y)` at gp.py:62 is per-datum)."""
    chol = _robust_cholesky(data, hypers)
    alpha = jax.scipy.linalg.cho_solve((chol, True), data.y)
    n = jnp.maximum(jnp.sum(data.mask), 1.0)
    quad = jnp.dot(data.y, alpha)
    # Padded rows have unit diagonal -> log-det contribution 0.
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    return -0.5 * (quad + logdet + n * _LOG_2PI) / n


class _AdamState(NamedTuple):
    m: GPHypers
    v: GPHypers
    t: jax.Array


def _adam_update(g, st: _AdamState, lr, b1=0.9, b2=0.999, eps=1e-8):
    t = st.t + 1
    # Dtype-pinned bias corrections: `b1 ** t` with a traced integer promotes to
    # the x64-default float when float64 is enabled, which would poison the scan
    # carry dtype; compute in the parameter dtype explicitly.
    m = jax.tree.map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, st.m, g)
    v = jax.tree.map(lambda v_, g_: b2 * v_ + (1 - b2) * g_ * g_, st.v, g)

    def _step_leaf(m_, v_):
        dt = m_.dtype
        tf = t.astype(dt)
        c1 = 1 - jnp.asarray(b1, dt) ** tf
        c2 = 1 - jnp.asarray(b2, dt) ** tf
        return jnp.asarray(lr, dt) * (m_ / c1) / (jnp.sqrt(v_ / c2) + eps)

    step = jax.tree.map(_step_leaf, m, v)
    return step, _AdamState(m=m, v=v, t=t)


@partial(jax.jit, static_argnames=("n_train",))
def fit_gp(
    data: GPData,
    hypers: GPHypers | None = None,
    n_train: int = 500,
    lr: float = 0.01,
) -> tuple[GPHypers, jax.Array]:
    """Adam on the negative MLL with |delta loss| < 1e-3 early-stop freezing.

    ≙ fit_gp, /root/reference/gpmpc/gp.py:49-69. Fixed-length scan: iterations after
    convergence are masked no-ops so one compiled program serves every dataset size.
    Returns (hypers, final loss).
    """
    if hypers is None:
        hypers = init_hypers(data.x.dtype)

    # Accelerator f32 matmuls may default to reduced-precision passes (TF32 on
    # a GPU), and a long Adam run drives the likelihood noise toward its floor
    # until the Gram's conditioning exceeds what those passes keep — the
    # config-default 500-iteration fit then NaNs. The fit is off the control
    # hot path, so full-precision matmuls cost nothing that matters; see also
    # _robust_cholesky's jitter escalation.
    with jax.default_matmul_precision("highest"):
        return _fit_gp_highest(data, hypers, n_train, lr)


def _fit_gp_highest(data, hypers, n_train, lr):
    loss_fn = lambda h: -marginal_log_likelihood(h, data)
    grad_fn = jax.value_and_grad(loss_fn)
    zeros = jax.tree.map(jnp.zeros_like, hypers)
    adam0 = _AdamState(m=zeros, v=zeros, t=jnp.asarray(0, jnp.int32))

    def body(carry, _):
        h, adam, last_loss, frozen = carry
        loss, g = grad_fn(h)
        # Belt-and-braces under the jitter escalation: if a step still produces
        # a non-finite loss/gradient (all escalation levels failed), skip the
        # update instead of poisoning the hypers — the fit recovers on the next
        # finite step rather than NaN-ing every later iteration.
        finite = jnp.logical_and(
            jnp.isfinite(loss),
            jax.tree.reduce(
                jnp.logical_and,
                jax.tree.map(lambda g_: jnp.all(jnp.isfinite(g_)), g),
            ),
        )
        skip = jnp.logical_or(frozen, jnp.logical_not(finite))
        step, adam_new = _adam_update(g, adam, lr)
        h_new = jax.tree.map(lambda p, s: p - s, h, step)
        # Early stopping if converged (gp.py:65-66): freeze all later updates.
        now_frozen = jnp.logical_or(
            frozen, jnp.logical_and(finite, jnp.abs(last_loss - loss) < 1e-3)
        )
        h_out = jax.tree.map(lambda old, new: jnp.where(skip, old, new), h, h_new)
        adam_out = jax.tree.map(lambda old, new: jnp.where(skip, old, new), adam, adam_new)
        loss_out = jnp.where(skip, last_loss, loss)
        return (h_out, adam_out, loss_out, now_frozen), None

    init = (hypers, adam0, jnp.asarray(jnp.inf, data.x.dtype), jnp.asarray(False))
    (hypers, _, last_loss, _), _ = jax.lax.scan(body, init, None, length=n_train)
    return hypers, last_loss


def posterior(hypers: GPHypers, data: GPData) -> GPPosterior:
    """Factorize K + sigma^2 I and cache alpha = K^-1 y (≙ compute_covariances,
    gp.py:43-46, but Cholesky-based; same jitter escalation as the fit).

    Full-precision matmuls for the same reason as fit_gp: the trained noise sits
    near its floor, where the bf16-precision Gram can lose positive-definiteness.
    """
    with jax.default_matmul_precision("highest"):
        chol = _robust_cholesky(data, hypers)
        alpha = jax.scipy.linalg.cho_solve((chol, True), data.y)
    return GPPosterior(chol=chol, alpha=alpha)


def predict_mean(
    hypers: GPHypers, data: GPData, post: GPPosterior, z: jax.Array
) -> jax.Array:
    """Posterior mean k(z, X) alpha at test points z: (n, D) -> (n,).

    ≙ gpytorch_predict2casadi's exported mean (gp.py:72-85).
    """
    K_zx = se_kernel(z, data.x, hypers.lengthscale, hypers.outputscale) * data.mask[None, :]
    return K_zx @ post.alpha


def predict_var(
    hypers: GPHypers, data: GPData, post: GPPosterior, z: jax.Array, include_noise: bool = True
) -> jax.Array:
    """Exact posterior variance diag at z: (n, D) -> (n,).

    The reference approximates this with GPyTorch LOVE fast predictive variances
    (fast_pred_var, gpmpc.py:443-445); at these dataset sizes the exact Cholesky
    path is both cheaper and exact.
    """
    K_zx = se_kernel(z, data.x, hypers.lengthscale, hypers.outputscale) * data.mask[None, :]
    v = jax.scipy.linalg.solve_triangular(post.chol, K_zx.T, lower=True)
    var = hypers.outputscale - jnp.sum(v * v, axis=0)
    var = jnp.maximum(var, 1e-12)
    if include_noise:
        var = var + hypers.noise
    return var
