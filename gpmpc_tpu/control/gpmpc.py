"""GP-MPC: nonlinear MPC with GP residual dynamics and chance-constraint tightening.

≙ /root/reference/gpmpc/gpmpc.py:15-514, rebuilt for batched accelerators. Key structural changes
from the reference (all behavior-preserving unless flagged as a documented quirk):

  * No codegen boundary. The reference re-generates and recompiles an acados C
    solver whenever the GP dataset size changes (gpmpc.py:97-108,213-218). Here the
    GP dataset lives in fixed-capacity padded buffers inside `GpModel`, which is a
    *runtime argument* of one jitted controller step — retraining the GP is a pure
    data update and never triggers recompilation.
  * No dual GP representation. The reference trains in GPyTorch and re-expresses
    the posterior mean in CasADi, synchronizing numerics at recompile time
    (gp.py:72-85, gpmpc.py:402-423). Here the same jnp kernel expression serves
    training, in-dynamics mean, and tightening variance.
  * The GP-augmented dynamics (setup_acados_model, gpmpc.py:166-221) are a traced
    function: prior f(x, u) plus the residual rotated into world axes by
    (cos phi sin theta, -sin phi, cos phi cos theta) at rows [1, 3, 5] and the
    phi/theta rate-residual rows [9, 10] (gpmpc.py:193-197), RK4-discretized.
  * Constraint tightening (propagate_constraint_limits, gpmpc.py:425-498) is a
    `lax.scan` over the horizon, and tightened constraints enter the QP directly
    as per-stage box bounds instead of acados runtime parameters.

Documented quirks deliberately not copied (SURVEY.md §7):
  * the x-axis variance rotation factor uses the mathematically consistent
    (cos phi sin theta)^2; the reference computes cos(phi) * sin(theta)^2
    (gpmpc.py:448) — a missing square on the cosine;
  * predictive variance excludes the likelihood noise term (the reference adds
    noise twice: once inside `gp.likelihood(...)` at gpmpc.py:444 and again via
    cov_noise_batch at gpmpc.py:459-465); the noise still enters once through
    cov_noise, matching intent;
  * preprocessing uses the actual env dt rather than a hardcoded 1/60
    (gpmpc.py:127);
  * posterior weights come from Cholesky solves, not dense inverses (gp.py:46).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gpmpc_tpu.control import mpc as mpc_mod
from gpmpc_tpu.control.mpc import MPC, MpcConsts, MpcState
from gpmpc_tpu.gp.exact_gp import (
    GPData,
    GPHypers,
    fit_gp,
    init_hypers,
    posterior,
)
from gpmpc_tpu.gp.kernels import se_kernel
from gpmpc_tpu.gp.sparse import fitc_posterior, select_inducing
from gpmpc_tpu.models import quadrotor
from gpmpc_tpu.models.quadrotor import GRAVITY, QuadrotorParams
from gpmpc_tpu.models.residual import QUADROTOR_SPEC, ResidualSpec
from gpmpc_tpu.models.symbolic import SymbolicModel
from gpmpc_tpu.ops import discretize_linear_system, lqr_gain_discrete
from gpmpc_tpu.ops.sqp import OcpBounds, SqpConfig, sqp_solve

# The residual structure is per-model data (models/residual.py::ResidualSpec);
# every function below takes a `spec` (defaulting to the quadrotor's, the
# reference's hardwired structure) or derives it from the model in scope.
# Quadrotor aliases kept as the reference-shaped public surface:
# uncertainty rows [dx, dy, dz, dphi, dtheta] (gpmpc.py:68-69) and the GP
# input layout [thrust | phi, dphi, phi_cmd | theta, dtheta, theta_cmd]
# (preprocess_data concat order, gpmpc.py:149; gp_idx at gpmpc.py:59).
UNCERTAIN_DIM = QUADROTOR_SPEC.uncertain_dim
GP_IDX = QUADROTOR_SPEC.gp_idx
GP_INPUT_DIM = QUADROTOR_SPEC.gp_input_dim  # padded per-GP slice dimension
NUM_GPS = QUADROTOR_SPEC.num_gps


def model_spec(model: SymbolicModel) -> ResidualSpec:
    """The model's residual-GP structure; quadrotor models built before the
    spec existed (residual_spec=None) keep their old hardwired behavior."""
    return model.residual_spec if model.residual_spec is not None else QUADROTOR_SPEC


class GpModel(NamedTuple):
    """Padded GP ensemble state — a pure-data controller argument.

    Shapes below are written for the quadrotor's (G=3 GPs, D=3-wide input
    slices); every consumer derives (G, D) from the leaves, so other model
    families' ensembles ride the same pytree."""

    # Full training set, per GP slice space. Leading axis: the G GPs.
    Z: jax.Array  # (3, M, 3)
    y: jax.Array  # (3, M)
    mask: jax.Array  # (3, M)
    hypers: GPHypers  # leaves shaped (3,)
    # Mean-prediction inducing set: FITC subset if sparse, else the full set.
    Zs: jax.Array  # (3, Ms, 3)
    alpha_s: jax.Array  # (3, Ms)
    # Predictive-variance quadratic form: var(z) = sf2 - k(z,var_Z) var_mat k'.
    # Exact mode: var_Z = Z, var_mat = K_inv (the reference's dense-inverse cache,
    # ≙ compute_covariances gp.py:43-46 — the right call for the batched hot
    # path: variance becomes pure GEMMs, no per-step triangular solves).
    # Sparse mode: var_Z = Zs, var_mat = the FITC variance form (gp/sparse.py::
    # fitc_posterior) — O(Ms^2) per query instead of O(M^2), the inducing-point
    # analogue of the reference's LOVE fast_pred_var (gpmpc.py:443-445).
    var_Z: jax.Array  # (3, Mv, 3)
    var_mat: jax.Array  # (3, Mv, Mv)
    var_mask: jax.Array  # (3, Mv)
    trained: jax.Array  # scalar bool


class GpMpcConsts(NamedTuple):
    mpc: MpcConsts
    Ad: jax.Array  # (nx, nx) exact discretization of prior Jacobian at equilibrium
    Bd_in: jax.Array  # (nx, nu)
    lqr_gain: jax.Array  # (nu, nx)
    Bd: jax.Array  # (nx, 5) uncertainty injection matrix
    inverse_cdf: jax.Array  # scalar chance-constraint quantile
    dt: jax.Array  # scalar


def empty_gp_model(
    max_points: int,
    max_inducing: int,
    dtype=jnp.float32,
    ard: bool = False,
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> GpModel:
    """`max_inducing` sizes both the mean inducing set and the variance form
    (callers pass max_inducing == max_points for the exact/dense mode)."""
    M, Ms = max_points, max_inducing
    G, D = spec.num_gps, spec.gp_input_dim
    zeros_g = jnp.zeros((G,), dtype)
    # The lengthscale leaf shape must match what train_gp_models will produce —
    # otherwise the first retrain changes the pytree structure and recompiles the
    # jitted controller step, breaking the no-recompile invariant.
    ell0 = jnp.zeros((G, D), dtype) if ard else zeros_g
    return GpModel(
        Z=jnp.zeros((G, M, D), dtype),
        y=jnp.zeros((G, M), dtype),
        mask=jnp.zeros((G, M), dtype),
        hypers=GPHypers(ell0, zeros_g, zeros_g),
        Zs=jnp.zeros((G, Ms, D), dtype),
        alpha_s=jnp.zeros((G, Ms), dtype),
        var_Z=jnp.zeros((G, Ms, D), dtype),
        var_mat=jnp.zeros((G, Ms, Ms), dtype),
        var_mask=jnp.zeros((G, Ms), dtype),
        trained=jnp.asarray(False),
    )


def slice_gp_inputs(
    xz: jax.Array, spec: ResidualSpec = QUADROTOR_SPEC
) -> jax.Array:
    """(..., z_dim) GP input rows -> (G, ..., gp_input_dim) padded per-GP slices."""
    pads = []
    for idx in spec.gp_idx:
        cols = [xz[..., i] for i in idx]
        while len(cols) < spec.gp_input_dim:
            cols.append(jnp.zeros_like(xz[..., 0]))
        pads.append(jnp.stack(cols, axis=-1))
    return jnp.stack(pads, axis=0)


def gp_input_from_xu(x: jax.Array, u: jax.Array) -> jax.Array:
    """(x, u) -> the quadrotor's 7-dim GP input [T, phi, dphi, phi_cmd, theta,
    dtheta, theta_cmd] (≙ the z-index selection idx_T/idx_R/idx_P at
    gpmpc.py:173). Alias of QUADROTOR_SPEC.gp_input; other families use
    `model_spec(model).gp_input`."""
    return QUADROTOR_SPEC.gp_input(x, u)


def pack_training_data(
    xz: jax.Array, yg: jax.Array, max_points: int, spec: ResidualSpec = QUADROTOR_SPEC
) -> GPData:
    """(N, z_dim) inputs / (N, G) targets -> padded per-GP GPData batch (leaves
    lead with the GP axis). N may be traced-dynamic via a validity mask upstream;
    here N is the static array length and all rows are marked active."""
    n = xz.shape[0]
    z = slice_gp_inputs(xz, spec)  # (G, N, D)
    pad = max_points - n
    Z = jnp.pad(z, ((0, 0), (0, pad), (0, 0)))
    Y = jnp.pad(yg.T, ((0, 0), (0, pad)))
    mask = jnp.pad(jnp.ones((spec.num_gps, n), xz.dtype), ((0, 0), (0, pad)))
    return GPData(x=Z, y=Y, mask=mask)


def pack_training_buffers(
    bufx: jax.Array, bufy: jax.Array, count, spec: ResidualSpec = QUADROTOR_SPEC
) -> GPData:
    """Padded (cap, z_dim)/(cap, G) buffers + traced active-row count -> masked
    GPData.

    The traced-count sibling of `pack_training_data`: rows >= `count` stay in
    the buffers but are masked out of the likelihood/posterior, so dataset
    growth inside a jitted program (the seed sweep, the online learner) never
    changes shapes."""
    cap = bufx.shape[0]
    mask = (jnp.arange(cap) < count).astype(bufx.dtype)
    return GPData(
        x=slice_gp_inputs(bufx, spec), y=bufy.T,
        mask=jnp.tile(mask[None], (spec.num_gps, 1)),
    )


def train_gp_models(
    data: GPData,  # leaves batched over the 3 GPs
    key: jax.Array,
    sparse: bool,
    max_inducing: int,
    n_train: int,
    lr: float,
    ard: bool = False,
) -> GpModel:
    """Fit hypers, factorize posteriors, and build the mean-inducing set — fully
    traceable (works inside one jitted multi-chip training step).

    ≙ train_gp (gpmpc.py:153-164) + the solver-rebuild work that the reference
    defers to reset()/setup_acados_* (gpmpc.py:94-111,166-273), which here is just
    constructing the `GpModel` pytree. Model-agnostic: the number of GPs and
    the per-GP input width both come from `data`'s leaf shapes.
    """
    h0 = init_hypers(data.x.dtype, data.x.shape[-1] if ard else None)
    hypers, _ = jax.vmap(lambda d: fit_gp(d, hypers=h0, n_train=n_train, lr=lr))(data)
    hypers = GPHypers(*hypers)
    post = jax.vmap(posterior)(hypers, data)

    if sparse:
        # Mean AND variance from the inducing set: the O(M^2)-per-query exact
        # variance (and its O(M^3) K_inv factorization) is never built — at
        # M = 5k that is the difference between GEMM-bound and fast.
        idx_s, s_mask = select_inducing(key, data.mask[0], max_inducing)
        Zs, alpha_s, W = jax.vmap(
            lambda h, d: fitc_posterior(h, d, idx_s, s_mask)
        )(hypers, data)
        var_Z, var_mask = Zs, jnp.tile(s_mask[None], (data.x.shape[0], 1))
    else:
        M = data.x.shape[1]
        eye = jnp.eye(M, dtype=data.x.dtype)
        # Train-time factorization: full-precision solves (see exact_gp.fit_gp).
        with jax.default_matmul_precision("highest"):
            W = jax.vmap(lambda c: jax.scipy.linalg.cho_solve((c, True), eye))(post.chol)
        Zs, alpha_s = data.x, post.alpha
        var_Z, var_mask = data.x, data.mask

    return GpModel(
        Z=data.x, y=data.y, mask=data.mask, hypers=hypers,
        Zs=Zs, alpha_s=alpha_s,
        var_Z=var_Z, var_mat=W, var_mask=var_mask,
        trained=jnp.asarray(True),
    )


def gp_residual(
    gp: GpModel, x: jax.Array, u: jax.Array, spec: ResidualSpec = QUADROTOR_SPEC
) -> jax.Array:
    """Residual dynamics term (nx,): GP posterior means injected into the
    model's uncertain rows through the spec's mean map. ≙ res_dyn,
    gpmpc.py:193-197 (where the map is the world-axis thrust rotation)."""
    z = spec.gp_input(x, u)  # (z_dim,)
    zs = slice_gp_inputs(z, spec)  # (G, D)

    def mean_one(Zs_i, alpha_i, ell_i, sf2_i, z_i):
        k = se_kernel(z_i[None, :], Zs_i, ell_i, sf2_i)[0]
        return jnp.dot(k, alpha_i)

    ell = jax.nn.softplus(gp.hypers.raw_lengthscale)
    sf2 = jax.nn.softplus(gp.hypers.raw_outputscale)
    preds = jax.vmap(mean_one)(gp.Zs, gp.alpha_s, ell, sf2, zs)  # (G,)
    rows = spec.mean_rows(preds, z)  # (n_unc,)
    return jnp.zeros_like(x).at[jnp.asarray(spec.uncertain_dim)].set(rows)


def augmented_fd(model: SymbolicModel, gp: GpModel, x: jax.Array, u: jax.Array) -> jax.Array:
    """RK4 discretization of prior + GP residual (≙ gpmpc.py:199-209)."""
    spec = model_spec(model)
    f = lambda x_, u_: model.fc_func(x_, u_) + gp_residual(gp, x_, u_, spec)
    return quadrotor.rk4(f, x, u, model.dt)


def gp_variances(gp: GpModel, z_slices: jax.Array, bf16: bool = False) -> jax.Array:
    """Predictive variance (G, ...) at per-GP query slices (G, ..., D) via the
    var_mat quadratic form (exact K_inv or FITC — see GpModel).

    ≙ the LOVE fast-variance call at gpmpc.py:443-445. With `bf16`, the
    O(N·Mv^2) GEMM runs in bfloat16 with f32 accumulation, for a variance
    that only feeds sqrt-scale bound offsets.
    """
    G, D = z_slices.shape[0], z_slices.shape[-1]
    batch_shape = z_slices.shape[1:-1]
    z_flat = z_slices.reshape(G, -1, D)
    ell = jax.nn.softplus(gp.hypers.raw_lengthscale)
    sf2 = jax.nn.softplus(gp.hypers.raw_outputscale)

    def var_one(Zv, mv, W, ell_i, sf2_i, z):
        k = se_kernel(z, Zv, ell_i, sf2_i) * mv[None, :]  # (N, Mv)
        if bf16:
            t = jnp.dot(
                k.astype(jnp.bfloat16), W.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        else:
            # Full-precision quadratic form: for a floor-noise GP the W
            # entries reach ~1/noise (1e5-ish) and cancel to a variance ~1e-2;
            # reduced-precision passes (bf16, TF32) turn that cancellation into
            # garbage tightenings. The opt-in bf16 branch above stays the
            # documented fast-and-loose mode.
            t = jnp.matmul(k, W, precision=jax.lax.Precision.HIGHEST)
        return jnp.maximum(sf2_i - jnp.sum(t * k, axis=-1), 1e-12)

    covs = jax.vmap(var_one)(gp.var_Z, gp.var_mask, gp.var_mat, ell, sf2, z_flat)
    return covs.reshape((G,) + batch_shape)


def propagate_constraint_limits(
    consts: GpMpcConsts,
    gp: GpModel,
    x_prev: jax.Array,  # (T+1, nx) previous MPC solution
    u_prev: jax.Array,  # (T, nu)
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> tuple[jax.Array, jax.Array]:
    """Per-stage bound tightenings (t_x: (T+1, nx), t_u: (T, nu)), both >= 0.

    ≙ propagate_constraint_limits, gpmpc.py:425-498. The reference returns signed
    constraint offsets for the [-I; I] constraint rows; since |A| = 1 for box rows,
    the tightening magnitude ppf * sqrt(diag(cov)) applies symmetrically to both
    sides, which is how it is returned here.
    """
    zq = spec.gp_input(x_prev[:-1], u_prev)  # (T, z_dim)
    covs_diag = gp_variances(gp, slice_gp_inputs(zq, spec))  # (G, T)
    return tightening_from_variances(consts, gp, zq, covs_diag, spec)


def disturbance_diagonals(
    consts: GpMpcConsts,
    gp: GpModel,
    zq: jax.Array,  # (T, z_dim) GP inputs along the previous solution
    covs_diag: jax.Array,  # (G, T) predictive variances (precomputed)
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> jax.Array:
    """Per-stage diagonals of the (n_unc x n_unc) disturbance covariance —
    GP variance mapped onto the uncertain rows through the spec's factor map
    (the quadrotor's world-axis rotation, ≙ gpmpc.py:452-469) plus the GP
    observation noise, (T, n_unc)."""
    dt2 = consts.dt**2
    noise = jax.nn.softplus(gp.hypers.raw_noise) + 1e-6  # (G,)
    F = spec.var_factors(zq)  # (T, n_unc, G)
    cov_d = jnp.einsum("tdg,gt->td", F, covs_diag)  # (T, n_unc)
    cov_n = F @ noise  # (T, n_unc)
    return (cov_d + cov_n) * dt2


def tightening_from_variances(
    consts: GpMpcConsts,
    gp: GpModel,
    zq: jax.Array,  # (T, z_dim) GP inputs along the previous solution
    covs_diag: jax.Array,  # (G, T) predictive variances (precomputed)
    spec: ResidualSpec = QUADROTOR_SPEC,
) -> tuple[jax.Array, jax.Array]:
    """Covariance-propagation scan given precomputed GP variances — split out so
    batched callers can compute the variances with one fused kernel over all
    scenarios (see batched_prepare_step)."""
    nx = consts.Ad.shape[0]
    cov_dn = disturbance_diagonals(consts, gp, zq, covs_diag, spec)

    # Tiny (nx, nx) matmuls — pin full precision (see select_action's note);
    # cost is negligible, and the recursion squares any bf16 round-off T times.
    return _tightening_scan_highest(consts, cov_dn, zq.dtype, nx)


def _tightening_scan_highest(consts, cov_dn, dtype, nx):
    with jax.default_matmul_precision("highest"):
        return _tightening_scan(consts, cov_dn, dtype, nx)


def _tightening_scan(consts, cov_dn, dtype, nx):
    K = consts.lqr_gain
    A, B, Bd = consts.Ad, consts.Bd_in, consts.Bd
    ppf = consts.inverse_cdf

    def step(cov_x, cov_dn_k):
        cov_xu = cov_x @ K.T
        cov_u = K @ cov_x @ K.T
        t_x = ppf * jnp.sqrt(jnp.maximum(jnp.diag(cov_x), 0.0))
        t_u = ppf * jnp.sqrt(jnp.maximum(jnp.diag(cov_u), 0.0))
        cov_next = (
            A @ cov_x @ A.T
            + A @ cov_xu @ B.T
            + B @ cov_xu.T @ A.T
            + B @ cov_u @ B.T
            + Bd @ jnp.diag(cov_dn_k) @ Bd.T
        )
        return cov_next, (t_x, t_u)

    cov0 = jnp.zeros((nx, nx), dtype)
    cov_T, (t_x_path, t_u) = jax.lax.scan(step, cov0, cov_dn)
    t_x_term = ppf * jnp.sqrt(jnp.maximum(jnp.diag(cov_T), 0.0))
    t_x = jnp.concatenate([t_x_path, t_x_term[None]], axis=0)
    return t_x, t_u


def _gp_disturbance_batch(
    consts: GpMpcConsts,
    gp: GpModel,
    zq: jax.Array,  # (B, T, z_dim)
    covs: jax.Array,  # (G, B, T)
    spec: ResidualSpec,
) -> jax.Array:
    """(B, T, n_unc) disturbance diagonals; vmaps over per-scenario GP leaves
    when `gp` carries a leading batch axis (gp_batched populations)."""
    if gp_is_batched(gp, spec):
        return jax.vmap(
            lambda g, z_b, cv_b: disturbance_diagonals(consts, g, z_b, cv_b, spec)
        )(gp, zq, jnp.moveaxis(covs, 1, 0))
    return jax.vmap(
        lambda z_b, cv_b: disturbance_diagonals(consts, gp, z_b, cv_b, spec)
    )(zq, jnp.moveaxis(covs, 1, 0))


def gp_is_batched(gp: GpModel, spec: ResidualSpec) -> bool:
    """True if every GpModel leaf carries a leading scenario/population axis
    (parallel/batch.py::batched_episode(gp_batched=True))."""
    return gp.Zs.ndim == 4


def preprocess_data_jnp(
    model: SymbolicModel,
    acc_a: float,
    acc_b: float,
    x: jax.Array,  # (N, nx)
    u: jax.Array,  # (N, nu)
    x_next: jax.Array,  # (N, nx)
) -> tuple[jax.Array, jax.Array]:
    """Pure-jnp transition preprocessing (usable inside jitted training steps).

    ≙ preprocess_data, gpmpc.py:113-151: targets are finite-difference state
    derivatives minus the prior model's prediction — the thrust-magnitude residual
    for the acceleration GP (rows 1/3/5 via |v_dot + g e_z|) and the phi/theta rate
    residual rows. dt = model dt (the reference hardcodes 1/60; documented quirk).
    """
    dt = model.dt
    thrust_cmd = u[:, 0]
    x_dot = (x_next - x) / dt

    acc = jnp.sqrt(x_dot[:, 1] ** 2 + x_dot[:, 3] ** 2 + (x_dot[:, 5] + GRAVITY) ** 2)
    acc_target = acc - (acc_a * thrust_cmd + acc_b)
    f_prior = jax.vmap(model.fc_func)(x, u)

    idx_phi, idx_d_phi, idx_phi_cmd = 6, 9, 1
    phi_target = x_dot[:, idx_phi] - f_prior[:, idx_phi]
    idx_theta, idx_d_theta, idx_theta_cmd = 7, 10, 2
    theta_target = x_dot[:, idx_theta] - f_prior[:, idx_theta]

    train_input = jnp.stack(
        [
            thrust_cmd,
            x[:, idx_phi], x[:, idx_d_phi], u[:, idx_phi_cmd],
            x[:, idx_theta], x[:, idx_d_theta], u[:, idx_theta_cmd],
        ],
        axis=1,
    )
    train_output = jnp.stack((acc_target, phi_target, theta_target), axis=1)
    return train_input, train_output


def _bounds_from_tightening(
    consts: GpMpcConsts,
    gp: GpModel,
    state: MpcState,
    obs: jax.Array,
    t_x: jax.Array,  # (T+1, nx) requested tightenings
    t_u: jax.Array,  # (T, nu)
    soft: bool = False,
) -> tuple[jax.Array, OcpBounds, jax.Array, jax.Array, jax.Array]:
    """Shared tail of step preparation: gate/clamp the tightening, build bounds,
    reference window, and warm start. Returns (xref, bounds, X_init, U_init,
    clamp_frac)."""
    T = consts.mpc.uref.shape[0]
    c = consts.mpc

    # First step has no previous rollout -> zero tightening (gpmpc.py:432-433).
    use = jnp.logical_and(state.traj_step > 0, gp.trained)
    t_x = jnp.where(use, t_x, 0.0)
    t_u = jnp.where(use, t_u, 0.0)

    # Keep tightened boxes feasible: never consume more than 45% of the interval
    # from each side (the reference would instead hit an acados failure status).
    # Every clamped entry is counted and surfaced in MpcInfo.clamp_frac — when
    # nonzero, the chance constraint is degraded and the caller must know.
    # With soft state bounds (SqpConfig.soft_x_penalty) the STATE tightening is
    # honored in full — infeasible (even crossed) boxes are well-posed for the
    # L1-penalized QP, and the degradation signal moves to MpcInfo.soft_viol.
    # Input bounds are actuator limits and always stay hard-clamped.
    lx = jnp.tile(c.lx[None], (T + 1, 1))
    ux = jnp.tile(c.ux[None], (T + 1, 1))
    lu = jnp.tile(c.lu[None], (T, 1))
    uu = jnp.tile(c.uu[None], (T, 1))
    cap_x = 0.45 * (ux - lx)
    cap_u = 0.45 * (uu - lu)
    n_clamped = jnp.sum(t_u > cap_u) + (0 if soft else jnp.sum(t_x > cap_x))
    clamp_frac = n_clamped.astype(jnp.float32) / float(t_x.size + t_u.size)
    if not soft:
        t_x = jnp.minimum(t_x, cap_x)
    t_u = jnp.minimum(t_u, cap_u)
    bounds = OcpBounds(lx=lx + t_x, ux=ux - t_x, lu=lu + t_u, uu=uu - t_u)

    xref = mpc_mod.reference_window(c.traj, state.traj_step, T)
    first = state.traj_step == 0
    X_init = jnp.where(first, jnp.tile(obs[None], (T + 1, 1)), state.X_warm)
    U_init = jnp.where(first, c.uref, state.U_warm)
    return xref, bounds, X_init, U_init, clamp_frac


def prepare_step(
    model: SymbolicModel,
    consts: GpMpcConsts,
    gp: GpModel,
    state: MpcState,
    obs: jax.Array,
    soft: bool = False,
) -> tuple[jax.Array, OcpBounds, jax.Array, jax.Array, jax.Array]:
    """Per-scenario step preparation: tightened bounds, reference window, warm
    start. (xref, bounds, X_init, U_init, clamp_frac). Vmappable."""
    spec = model_spec(model)
    t_x, t_u = propagate_constraint_limits(
        consts, gp, state.X_warm, state.U_warm, spec
    )
    return _bounds_from_tightening(consts, gp, state, obs, t_x, t_u, soft=soft)


def batched_variances(
    gp: GpModel,
    z_slices: jax.Array,  # (G, B, T, D)
    bf16: bool = False,
) -> jax.Array:
    """Tightening variances for a whole scenario batch, (G, B, T): one
    quadratic-form GEMM per GP over all B*T query points. Per-scenario GP
    populations (leaves with a leading B axis) vmap over the population:
    their variance form differs per scenario."""
    if gp.Zs.ndim == 4:  # per-scenario GP population
        return jnp.moveaxis(
            jax.vmap(lambda g, z: gp_variances(g, z, bf16=bf16))(
                gp, jnp.moveaxis(z_slices, 1, 0)
            ),
            0, 1,
        )  # vmap over B -> (B, G, T) -> (G, B, T)
    return gp_variances(gp, z_slices, bf16=bf16)


def batched_prepare_step(
    model: SymbolicModel,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,  # leaves batched over B
    obs: jax.Array,  # (B, nx)
    var_bf16: bool = False,
    soft: bool = False,
):
    """Batch-first step preparation: the GP variances of all B scenarios in
    one pass, then the T-step covariance recursion vmapped over scenarios.
    `gp` may be shared or a per-scenario population (leaves with a leading B
    axis)."""
    spec = model_spec(model)
    zq = jax.vmap(lambda s: spec.gp_input(s.X_warm[:-1], s.U_warm))(states)  # (B, T, z)
    with jax.named_scope("gp_variance"):
        covs = batched_variances(gp, slice_gp_inputs(zq, spec), var_bf16)
    with jax.named_scope("tightening"):
        if gp_is_batched(gp, spec):
            t_x, t_u = jax.vmap(
                lambda g, z_b, cv_b: tightening_from_variances(consts, g, z_b, cv_b, spec)
            )(gp, zq, jnp.moveaxis(covs, 1, 0))
        else:
            t_x, t_u = jax.vmap(
                lambda z_b, cv_b: tightening_from_variances(consts, gp, z_b, cv_b, spec)
            )(zq, jnp.moveaxis(covs, 1, 0))
    return jax.vmap(
        lambda s, o, tx, tu, g: _bounds_from_tightening(
            consts, g, s, o, tx, tu, soft=soft
        ),
        in_axes=(0, 0, 0, 0, 0 if gp_is_batched(gp, spec) else None),
    )(states, obs, t_x, t_u, gp)


def select_action(
    model: SymbolicModel,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    state: MpcState,
    obs: jax.Array,
) -> tuple[jax.Array, MpcState, mpc_mod.MpcInfo]:
    """One GP-MPC step (pure). ≙ GPMPC.select_action, gpmpc.py:334-368.

    Matmul precision is pinned to full f32: accelerator f32 matmuls may
    default to reduced-precision passes (TF32 on a GPU), and a GP trained to
    its noise floor (the config-default 500-iteration fit) produces
    ill-conditioned posterior algebra whose round-off compounds through
    jacfwd linearization -> Riccati until the solve NaNs. This is also the
    plain reference the QP kernel path is checked against.
    """
    with jax.default_matmul_precision("highest"):
        return _select_action_highest(model, cfg, consts, gp, state, obs)


def _select_action_highest(model, cfg, consts, gp, state, obs):
    c = consts.mpc
    xref, bounds, X_init, U_init, clamp_frac = prepare_step(
        model, consts, gp, state, obs, soft=cfg.soft_x_penalty is not None
    )
    if cfg.warm_shift:
        X_init = jnp.concatenate([X_init[1:], X_init[-1:]], axis=0)
        U_init = jnp.concatenate([U_init[1:], U_init[-1:]], axis=0)
    fd = partial(augmented_fd, model, gp)
    cost = mpc_mod.OcpCost(xref=xref, uref=c.uref, Q=c.Q, R=c.R, Qe=c.Q, scale=c.scale)
    sol = sqp_solve(fd, cost, bounds, obs, X_init, U_init, cfg)

    new_state = MpcState(traj_step=state.traj_step + 1, X_warm=sol.X, U_warm=sol.U)
    info = mpc_mod.MpcInfo(
        X=sol.X, U=sol.U, step_norm=sol.step_norm, qp_gap=sol.qp_gap,
        n_iters=sol.n_iters, clamp_frac=clamp_frac,
        soft_viol=mpc_mod.state_bound_violation(sol.X, bounds),
        eq_res=sol.eq_res, stat_res=sol.stat_res, converged=sol.converged,
    )
    return sol.U[0], new_state, info


def batched_select_action_lanes(
    model: SymbolicModel,
    cfg: SqpConfig,
    consts: GpMpcConsts,
    gp: GpModel,
    states: MpcState,  # leaves batched over B
    obs: jax.Array,  # (B, nx)
    interpret: bool = False,
    var_bf16: bool = False,
) -> tuple[jax.Array, MpcState, mpc_mod.MpcInfo]:
    """Batch GP-MPC step with the Pallas QP kernel (ops/pallas_ocp.py).

    Same semantics as vmap(select_action); the QP solves of all B scenarios
    go through one kernel launch per SQP iteration instead of XLA's batched
    small matmuls. Linearization is vmapped jacfwd under XLA.

    `gp` may carry a leading per-scenario axis (a GP population, one model per
    scenario — the seed sweep's shape): each scenario is then linearized
    against its own GP, and the QP still runs in the kernel.

    Matmul precision is pinned to full f32 around the XLA stages, as in
    select_action: a GP trained to its noise floor has posterior weights in
    the hundreds, and reduced-precision passes (TF32 on a GPU) in the GP
    mean's dot products can compound through the jacfwd Jacobians until the
    solve NaNs. The kernel itself is elementwise f32 and has no matmuls.
    """
    with jax.default_matmul_precision("highest"):
        return _batched_select_action_lanes_highest(
            model, cfg, consts, gp, states, obs, interpret, var_bf16
        )


def _batched_select_action_lanes_highest(
    model, cfg, consts, gp, states, obs, interpret, var_bf16
):
    from gpmpc_tpu.ops.sqp_lanes import sqp_solve_batch_lanes

    spec = model_spec(model)
    gp_batched = gp_is_batched(gp, spec)
    c = consts.mpc
    soft = cfg.soft_x_penalty is not None
    xref, bounds, X_init, U_init, clamp_frac = batched_prepare_step(
        model, consts, gp, states, obs, var_bf16=var_bf16, soft=soft,
    )
    if cfg.warm_shift:
        X_init = jnp.concatenate([X_init[:, 1:], X_init[:, -1:]], axis=1)
        U_init = jnp.concatenate([U_init[:, 1:], U_init[:, -1:]], axis=1)
    cost = mpc_mod.OcpCost(xref=xref, uref=c.uref, Q=c.Q, R=c.R, Qe=c.Q, scale=c.scale)
    if gp_batched:
        # Per-scenario GP population: linearize each scenario against ITS GP
        # (vmapped jacfwd over the population axis).
        def linearize(X, U):  # X (B, T, nx), U (B, T, nu)
            def one(g, Xb, Ub):
                fd_g = lambda x, u: augmented_fd(model, g, x, u)  # noqa: E731
                A, Bm = jax.vmap(jax.jacfwd(fd_g, argnums=(0, 1)))(Xb, Ub)
                return jax.vmap(fd_g)(Xb, Ub), A, Bm

            return jax.vmap(one)(gp, X, U)

        sol = sqp_solve_batch_lanes(
            None, cost, bounds, obs, X_init, U_init, cfg, interpret=interpret,
            linearize_fn=linearize,
        )
    else:
        fd = partial(augmented_fd, model, gp)
        fd_jac3 = None
        if cfg.analytic_jac and spec.name == "quadrotor":
            # hand-derived closed forms exist for the quadrotor family
            # (isotropic and ARD kernels); other families fall back to jacfwd
            from gpmpc_tpu.models.jacobians import make_augmented_fd_jac

            fd_jac3 = make_augmented_fd_jac(model, gp)
        sol = sqp_solve_batch_lanes(
            fd, cost, bounds, obs, X_init, U_init, cfg, interpret=interpret, fd_jac3=fd_jac3
        )
    new_states = MpcState(
        traj_step=states.traj_step + 1, X_warm=sol.X, U_warm=sol.U
    )
    info = mpc_mod.MpcInfo(
        X=sol.X, U=sol.U, step_norm=sol.step_norm, qp_gap=sol.qp_gap,
        n_iters=sol.n_iters, clamp_frac=clamp_frac,
        soft_viol=jax.vmap(mpc_mod.state_bound_violation)(sol.X, bounds),
        eq_res=sol.eq_res, stat_res=sol.stat_res, converged=sol.converged,
    )
    return sol.U[:, 0], new_states, info


class GPMPC:
    """Stateful wrapper mirroring the reference GPMPC API (gpmpc.py:15-514)."""

    U_EQ = np.array([0.3234, 0.0, 0.0, 0.0])

    def __init__(
        self,
        symbolic_model: SymbolicModel,
        traj,
        prior_params: dict | None,
        horizon: int,
        q_mpc,
        r_mpc,
        sparse_gp: bool = False,
        prob: float = 0.955,
        max_gp_samples: int = 30,
        seed: int = 1337,
        device: str = "gpu",
        output_dir=None,
        max_gp_points: int = 128,
        sqp_iters: int = 25,
        qp_iters: int = 15,
        parallel_scan: bool = False,
        ard_gp: bool = False,
        soft_constraints: float | None = None,
        bounds: tuple | None = None,
        lm_reg: float = 0.0,
        step_backend: str = "auto",
        interpret: bool = False,
    ):
        self.spec = model_spec(symbolic_model)
        if self.spec.name == "quadrotor":
            # ≙ the a/b-only prior-params validation at gpmpc.py:43-44; only
            # the quadrotor's thrust map consumes these
            # (setup_symbolic_acceleration, gpmpc.py:322-325).
            if prior_params is None or any(k not in prior_params for k in ("a", "b")):
                raise ValueError(
                    "GPMPC requires prior_params to be defined and contain 'a' and 'b'."
                )
            if isinstance(prior_params, QuadrotorParams):
                self._acc_a, self._acc_b = float(prior_params.a), float(prior_params.b)
            else:
                self._acc_a, self._acc_b = float(prior_params["a"]), float(prior_params["b"])
        self.sparse = sparse_gp
        self.ard_gp = ard_gp  # per-dimension (ARD) lengthscales; reference uses isotropic
        self.output_dir = output_dir
        self.model = symbolic_model
        self.dt = symbolic_model.dt
        self.T = horizon
        self.max_gp_samples = max_gp_samples
        self.max_gp_points = max(max_gp_points, max_gp_samples)
        self.np_random = np.random.default_rng(seed)
        self._gp_key = jax.random.PRNGKey(seed)

        traj = jnp.asarray(traj)
        if traj.shape[0] < traj.shape[1]:
            traj = traj.T

        # Nominal prior controller (≙ gpmpc.py:72-80).
        self.prior_ctrl = MPC(
            symbolic_model, traj, q_mpc=q_mpc, r_mpc=r_mpc,
            output_dir=output_dir, horizon=horizon,
            sqp_iters=sqp_iters, qp_iters=qp_iters, parallel_scan=parallel_scan,
            bounds=bounds, lm_reg=lm_reg,
        )
        self.traj = traj

        # Chance-constraint quantile (gpmpc.py:63-65).
        nx = symbolic_model.nx
        # Host-side stdlib math: a scalar computed once at construction.
        import statistics

        inverse_cdf = float(
            statistics.NormalDist().inv_cdf(1 - (1 / nx - (prob + 1) / (2 * nx)))
        )

        # Prior linearization at equilibrium -> exact discretization + LQR gain
        # (gpmpc.py:81-86,500-507). Each family carries its own trim pair
        # (quadrotor: hover at the origin; two-link: gravity compensation at
        # q=(-pi/2, 0.7)) so (x_eq, u_eq) is an actual equilibrium.
        x_eq = (
            np.asarray(symbolic_model.x_eq, np.float32)
            if symbolic_model.x_eq is not None
            else np.zeros(nx, np.float32)
        )
        u_eq = (
            np.asarray(symbolic_model.u_eq, np.float32)
            if symbolic_model.u_eq is not None
            else np.zeros(symbolic_model.nu, np.float32)
        )
        dfdx, dfdu = symbolic_model.df_func(x_eq, u_eq)
        Ad, Bd_in = discretize_linear_system(
            np.asarray(dfdx, np.float64), np.asarray(dfdu, np.float64), self.dt, exact=True
        )
        Q = np.diag(np.asarray(q_mpc, np.float64))
        R = np.diag(np.asarray(r_mpc, np.float64))
        lqr_K, _ = lqr_gain_discrete(Ad, Bd_in, Q, R)

        Bd_mat = np.eye(nx)[:, list(self.spec.uncertain_dim)]
        self.consts = GpMpcConsts(
            mpc=self.prior_ctrl.consts,
            Ad=jnp.asarray(Ad, jnp.float32),
            Bd_in=jnp.asarray(Bd_in, jnp.float32),
            lqr_gain=jnp.asarray(lqr_K, jnp.float32),
            Bd=jnp.asarray(Bd_mat, jnp.float32),
            inverse_cdf=jnp.asarray(inverse_cdf, jnp.float32),
            dt=jnp.asarray(self.dt, jnp.float32),
        )
        # soft_constraints: L1 penalty weight that makes the chance-tightened
        # STATE bounds soft (ops/boxqp.py bounded-multiplier formulation) so an
        # uncertain GP degrades the constraint gracefully and *visibly*
        # (MpcInfo.soft_viol) instead of being silently clamped at 45%.
        self.cfg = SqpConfig(
            sqp_iters=sqp_iters, qp_iters=qp_iters, parallel_scan=parallel_scan,
            soft_x_penalty=soft_constraints, lm_reg=lm_reg,
        )
        self.gp_model = empty_gp_model(
            self.max_gp_points,
            self.max_gp_samples if sparse_gp else self.max_gp_points,
            ard=ard_gp,
            spec=self.spec,
        )
        self.state = mpc_mod.init_state(horizon, nx, symbolic_model.nu)
        self._requires_recompile = False  # API compat: re-jit never needed here.
        # Per-step solve program, built lazily on first select_action so that
        # cfg tweaks after construction (ctrl.cfg = ctrl.cfg._replace(...))
        # take effect, and rebuilt if cfg changes later. step_backend ("auto",
        # "lanes" or "xla") and interpret go to parallel/batch.py::
        # dispatch_decision: the QP kernel on a GPU, the XLA path on the CPU
        # unless interpret=True runs the kernel in Pallas interpret mode.
        from gpmpc_tpu.parallel.batch import BACKENDS

        if step_backend not in BACKENDS:
            raise ValueError(
                f"step_backend must be 'auto', 'lanes' or 'xla', got {step_backend!r}"
            )
        self.step_backend = step_backend
        self.interpret = interpret
        self._step = None
        self._step_key = None
        self._train_fns: dict = {}  # (iterations, lr) -> jitted training program

    def _dispatch(self):
        from gpmpc_tpu.parallel.batch import dispatch_decision

        return dispatch_decision(self.step_backend, interpret=self.interpret)

    def _resolve_step_backend(self) -> str:
        return self._dispatch().path

    def _get_step(self):
        """(Re)build the jitted per-step program when cfg or backend changed."""
        key = (self.cfg, self.step_backend, self.interpret)
        if self._step is not None and self._step_key == key:
            return self._step
        decision = self._dispatch()
        if decision.path == "lanes":
            model, cfg, interpret = self.model, self.cfg, decision.interpret

            def one(consts, gpm, state, obs):
                # Single scenario as a B=1 batch: the kernel pads the batch to
                # one scenario block (runtime/server.py batches live sessions
                # the same way).
                u, st, info = batched_select_action_lanes(
                    model, cfg, consts, gpm,
                    jax.tree.map(lambda l: l[None], state), obs[None],
                    interpret=interpret,
                )
                squeeze = lambda l: l[0] if getattr(l, "ndim", 0) > 0 else l
                return u[0], jax.tree.map(squeeze, st), jax.tree.map(squeeze, info)

            self._step = jax.jit(one)
        else:
            self._step = jax.jit(partial(select_action, self.model, self.cfg))
        self._step_key = key
        return self._step

    # -- reference-API attribute surface --------------------------------------
    # Read-only views with the reference's names/orientations so migrating
    # call sites that POKE at controller internals keep working
    # (≙ the instance attributes set at gpmpc.py:35-92,366-367; see
    # tests/test_reference_surface.py).

    @property
    def gaussian_process(self):
        """The trained GP ensemble, None before train_gp (≙ gpmpc.py:60,158).
        Here one padded `GpModel` pytree instead of a list of torch modules."""
        return self.gp_model if bool(self.gp_model.trained) else None

    @property
    def gp_idx(self):
        """Per-GP input-slice indices (≙ gpmpc.py:59)."""
        return [list(i) for i in self.spec.gp_idx]

    @property
    def traj_step(self) -> int:
        return int(self.state.traj_step)

    @property
    def x_prev(self):
        """Previous solution, (nx, T+1) — reference orientation
        (≙ gpmpc.py:366); None before the first solve."""
        if int(self.state.traj_step) == 0:
            return None
        return np.asarray(self.state.X_warm).T

    @property
    def u_prev(self):
        if int(self.state.traj_step) == 0:
            return None
        return np.asarray(self.state.U_warm).T

    @property
    def ref_action(self):
        """(nu, T) input reference (≙ gpmpc.py:54)."""
        return np.asarray(self.consts.mpc.uref).T

    @property
    def lqr_gain(self):
        return np.asarray(self.consts.lqr_gain)

    @property
    def inverse_cdf(self) -> float:
        return float(self.consts.inverse_cdf)

    # -- training-data path ---------------------------------------------------

    def preprocess_data(self, x, u, x_next):
        """Rollout transitions -> GP inputs (N, z_dim) and residual targets
        (N, G), via the model family's ResidualSpec.

        ≙ preprocess_data, gpmpc.py:113-151, with dt = the model/env step (the
        reference hardcodes 1/60 here; documented quirk). Quadrotor models keep
        the exact legacy behavior: the thrust-map coefficients come from the
        `prior_params` passed at construction (reference contract), not from
        the model's own parameter set.
        """
        x = jnp.asarray(x, jnp.float32)
        u = jnp.asarray(u, jnp.float32)
        x_next = jnp.asarray(x_next, jnp.float32)
        if self.spec.name == "quadrotor":
            xi, ti = preprocess_data_jnp(
                self.model, self._acc_a, self._acc_b, x, u, x_next
            )
        else:
            xi, ti = self.spec.make_targets(self.model, x, u, x_next)
        return np.asarray(xi), np.asarray(ti)

    def train_gp(self, x, y, lr: float, iterations: int):
        """Fit the G GPs to (N, z_dim) inputs / (N, G) targets. ≙ gpmpc.py:153-164.

        Training is one jitted, GP-batched program; dataset growth only changes the
        row mask, so no recompilation ever happens (vs. _requires_recompile=True in
        the reference).
        """
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        n = x.shape[0]
        M = self.max_gp_points
        if n > M:
            raise ValueError(f"GP dataset ({n}) exceeds capacity ({M}); raise max_gp_points")

        G, D = self.spec.num_gps, self.spec.gp_input_dim
        Z = np.zeros((G, M, D), np.float32)
        Y = np.zeros((G, M), np.float32)
        mask = np.zeros((G, M), np.float32)
        for i, idx in enumerate(self.spec.gp_idx):
            Z[i, :n, : len(idx)] = x[:, list(idx)]
            Y[i, :n] = y[:, i]
            mask[i, :n] = 1.0
        data = GPData(x=jnp.asarray(Z), y=jnp.asarray(Y), mask=jnp.asarray(mask))

        self._gp_key, sub = jax.random.split(self._gp_key)
        cache_key = (int(iterations), float(lr))
        if cache_key not in self._train_fns:
            self._train_fns[cache_key] = jax.jit(
                partial(
                    train_gp_models,
                    sparse=self.sparse,
                    max_inducing=self.max_gp_samples if self.sparse else M,
                    n_train=int(iterations),
                    lr=float(lr),
                    ard=self.ard_gp,
                )
            )
        self.gp_model = self._train_fns[cache_key](data, sub)
        self._requires_recompile = False

    # -- control path ---------------------------------------------------------

    def reset(self):
        """≙ GPMPC.reset (gpmpc.py:94-111) — without the recompile branch, which
        this design makes unnecessary."""
        self.state = mpc_mod.init_state(self.T, self.model.nx, self.model.nu)

    def reference_trajectory(self) -> np.ndarray:
        """Reference window at the current step, (nx, T+1). ≙ gpmpc.py:509-514."""
        return np.asarray(
            mpc_mod.reference_window(self.consts.mpc.traj, self.state.traj_step, self.T)
        ).T

    def select_action(self, obs) -> np.ndarray:
        obs = jnp.asarray(obs, jnp.float32)
        u, self.state, self._last_info = self._get_step()(
            self.consts, self.gp_model, self.state, obs
        )
        u = np.asarray(u)
        # ≙ `assert status in [0, 2]` after each acados solve (gpmpc.py:365).
        if not np.all(np.isfinite(u)):
            raise RuntimeError(
                f"GP-MPC solve produced non-finite action {u} "
                f"(step_norm={float(self._last_info.step_norm)})"
            )
        return u
