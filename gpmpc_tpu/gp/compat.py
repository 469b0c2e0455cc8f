"""Reference-API compatibility layer for the GP module.

Users migrating from /root/reference/gpmpc/gp.py find the same symbols here —
`covSE_single`, `covSE_vectorized`, `GaussianProcess`, `fit_gp` — implemented on
the native JAX stack. The CasADi exporter `gpytorch_predict2casadi` has no
equivalent by design: this framework has no dual GP representation (the traced
jnp posterior mean is embedded in the MPC directly), so `GaussianProcess.predict`
is the migration target for its call sites.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.gp import exact_gp
from gpmpc_tpu.gp.kernels import se_kernel


def covSE_single(x, z, ell, sf2):
    """SE kernel of one test point vs a training matrix. ≙ gp.py:12-14.

    x: (d,) test point; z: (d, n) training matrix (CasADi column convention);
    returns (n,) kernel row.
    """
    x = jnp.asarray(x).reshape(1, -1)
    z = jnp.asarray(z).T  # (n, d)
    return se_kernel(x, z, jnp.asarray(ell).reshape(()) if jnp.ndim(ell) <= 1 and jnp.size(ell) == 1 else jnp.asarray(ell).reshape(-1), jnp.asarray(sf2).reshape(()))[0]


def covSE_vectorized(x, Z, ell, sf2):
    """SE kernel of one test point vs an inducing matrix Z (n, d). ≙ gp.py:17-21."""
    x = jnp.asarray(x).reshape(1, -1)
    Z = jnp.asarray(Z)
    return se_kernel(x, Z, jnp.asarray(ell).reshape(()) if jnp.size(ell) == 1 else jnp.asarray(ell).reshape(-1), jnp.asarray(sf2).reshape(()))[0]


class GaussianProcess:
    """Exact GP with the reference's surface: construct from (x, y), `fit`,
    then predict. ≙ gp.py:24-46 (GPyTorch ExactGP wrapper).

    Attributes after fitting mirror the reference: `K` (Gram + noise), `K_inv`,
    `n_ind_points`, `input_dimension`.
    """

    def __init__(self, x, y):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32).reshape(-1)
        assert x.ndim == 2, "x must be a 2D array"
        assert x.shape[0] == y.shape[0]
        self.n_ind_points = x.shape[0]
        self.input_dimension = x.shape[1]
        self._data = exact_gp.GPData(
            x=jnp.asarray(x), y=jnp.asarray(y), mask=jnp.ones(x.shape[0], jnp.float32)
        )
        self.hypers = exact_gp.init_hypers()
        self._post = None
        self.K, self.K_inv = None, None

    def fit(self, n_train: int = 500, lr: float = 0.01):
        """Train hyperparameters (≙ fit_gp, gp.py:49-69) and cache K / K_inv."""
        self.hypers, loss = exact_gp.fit_gp(self._data, n_train=n_train, lr=lr)
        self._post = exact_gp.posterior(self.hypers, self._data)
        K = np.asarray(
            se_kernel(self._data.x, self._data.x, self.hypers.lengthscale, self.hypers.outputscale)
        ) + float(self.hypers.noise) * np.eye(self.n_ind_points)
        self.K = K
        self.K_inv = np.linalg.inv(K)  # ≙ compute_covariances, gp.py:43-46
        return float(loss)

    def predict(self, z, include_noise: bool = True):
        """Posterior mean and variance at z (n, d). Replaces both the GPyTorch
        predictive call and the CasADi-exported mean of the reference."""
        assert self._post is not None, "call fit() first"
        z = jnp.asarray(np.asarray(z, np.float32).reshape(-1, self.input_dimension))
        mean = exact_gp.predict_mean(self.hypers, self._data, self._post, z)
        var = exact_gp.predict_var(
            self.hypers, self._data, self._post, z, include_noise=include_noise
        )
        return np.asarray(mean), np.asarray(var)


def fit_gp(gp: GaussianProcess, n_train: int = 500, lr: float = 0.01, device: str = "gpu"):
    """Functional form matching the reference signature (gp.py:49). `device` is
    informational — JAX owns placement."""
    assert isinstance(gp, GaussianProcess), f"gp must be a GaussianProcess, got {type(gp)}"
    gp.fit(n_train=n_train, lr=lr)
    return gp
