"""Gaussian-process regression: log-marginal likelihood, posterior predict.

From-scratch replacement for sklearn.gaussian_process.GaussianProcessRegressor
(reference emulation.py:164-178, 496-499). One GP per principal component; all
states stack on a leading axis so fit and predict are single vmapped XLA
launches across PCs (and restarts during fit).

Conventions match sklearn (normalize_y=False):
  LML(theta_h) = -1/2 y^T K^-1 y - sum(log diag L) - n/2 log 2pi,
  K = kernel(X) + alpha * I
  predict mean = k*^T K^-1 y ; var = kernel.diag - ||L^-1 k*||^2 (clipped at 0)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from bayesian_inference_tpu.utils import struct

from bayesian_inference_tpu.ops.gram import (
    KernelConfig,
    KernelParams,
    cross_covariance,
    prior_variance,
    train_gram,
    train_gram_from_sqdiff,
)

_LOG_2PI = 1.8378770664093453


def log_marginal_likelihood(
    cfg: KernelConfig,
    params: KernelParams,
    X: jax.Array,
    y: jax.Array,
    alpha_jitter: float,
) -> jax.Array:
    """LML for one GP. Differentiable in ``params``; vmap over a stacked axis."""
    K = train_gram(cfg, params, X, alpha_jitter)
    L = jnp.linalg.cholesky(K)
    a = jax.scipy.linalg.cho_solve((L, True), y)
    n = y.shape[0]
    return -0.5 * (y @ a) - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * n * _LOG_2PI


def log_marginal_likelihood_sqdiff(
    cfg: KernelConfig,
    params: KernelParams,
    D2: jax.Array,
    y: jax.Array,
    alpha_jitter: float,
) -> jax.Array:
    """LML from precomputed ``pairwise_sqdiff(X)`` — the GP-fit objective.

    Identical value to :func:`log_marginal_likelihood`; the precomputed (n, n,
    ndim) tensor is shared across all vmapped fit instances.
    """
    K = train_gram_from_sqdiff(cfg, params, D2, alpha_jitter)
    L = jnp.linalg.cholesky(K)
    a = jax.scipy.linalg.cho_solve((L, True), y)
    n = y.shape[0]
    return -0.5 * (y @ a) - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * n * _LOG_2PI


def _dK_dsq(cfg: KernelConfig, sq: jax.Array) -> jax.Array:
    """d(kernel)/d(scaled squared distance), elementwise (for the closed-form
    LML gradient). Matches ops/gram.matern_from_sqdist including its sqrt
    guard; the diagonal's unbounded nu=0.5 value is always contracted against
    a zero squared-difference, so it never propagates."""
    if cfg.nu is None:
        return -0.5 * jnp.exp(-0.5 * sq)
    d = jnp.sqrt(sq + 1e-36)
    if cfg.nu == 0.5:
        return -jnp.exp(-d) / (2.0 * d)
    if cfg.nu == 1.5:
        t = jnp.sqrt(3.0) * d
        return -1.5 * jnp.exp(-t)
    if cfg.nu == 2.5:
        t = jnp.sqrt(5.0) * d
        return -(5.0 / 6.0) * (1.0 + t) * jnp.exp(-t)
    raise ValueError(f"Unsupported Matern nu={cfg.nu}")


@partial(jax.custom_vjp, nondiff_argnums=(0, 5))
def log_marginal_likelihood_matmul(
    cfg: KernelConfig,
    params: KernelParams,
    D2: jax.Array,
    y: jax.Array,
    alpha_jitter,
    precision=jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """LML with a matmul-only factorization and a closed-form gradient.

    Value-identical (up to fp reordering) to
    :func:`log_marginal_likelihood_sqdiff`, but the Cholesky runs through
    ops/blocked_cholesky (batched matmul panels + a batched diagonal-block
    factorization) and the gradient uses dLML/dK = (alpha alpha^T - K^{-1})/2
    chained through analytic dK/dtheta — no Cholesky backward pass anywhere.
    Nested-vmap safe: the factorization collapses all vmapped axes into one
    batch (blocked_cholesky.chol_inv_batched).

    ``precision`` (static) sets the factorization-panel and LML/gradient
    einsum fidelity for value AND grad — the GP fit's exploration stage
    passes HIGH (3-pass bf16), everything else keeps the HIGHEST default.
    It is an argument, not an ambient context, so it participates in every
    trace-cache key (jax caches custom_vjp traces by abstract args).
    """
    lml, _ = _lml_matmul_fwd(cfg, params, D2, y, alpha_jitter, precision)
    return lml


def _lml_matmul_fwd(cfg, params, D2, y, alpha_jitter, precision=jax.lax.Precision.HIGHEST):
    from bayesian_inference_tpu.ops.blocked_cholesky import chol_inv_batched

    from bayesian_inference_tpu.ops.gram import train_gram_from_sqdiff

    K = train_gram_from_sqdiff(cfg, params, D2, alpha_jitter)
    invL, half_logdet = chol_inv_batched(K[None], precision=precision)
    invL, half_logdet = invL[0], half_logdet[0]
    hi = precision
    alpha = jnp.einsum(
        "ji,j->i", invL, jnp.einsum("ij,j->i", invL, y, precision=hi), precision=hi
    )
    n = y.shape[0]
    lml = -0.5 * (y @ alpha) - half_logdet - 0.5 * n * _LOG_2PI
    return lml, (params, D2, y, alpha, invL)


def _lml_matmul_bwd(cfg, precision, res, g):
    params, D2, y, alpha, invL = res
    hi = precision
    Kinv = jnp.einsum("ki,kj->ij", invL, invL, precision=hi)
    G = 0.5 * (alpha[:, None] * alpha[None, :] - Kinv)

    w = jnp.exp(-2.0 * params.log_length_scale)              # (d,) = 1/ls^2
    sq = jnp.einsum("ijk,k->ij", D2, w, precision=hi)
    H = G * _dK_dsq(cfg, sq)
    d_log_ls = g * (-2.0) * w * jnp.einsum("ij,ijk->k", H, D2, precision=hi)
    zero = jnp.zeros((), G.dtype)
    d_log_noise = (
        g * jnp.exp(params.log_noise) * jnp.trace(G) if cfg.with_noise else zero
    )
    d_log_constant = (
        g * jnp.exp(params.log_constant) * jnp.sum(G) if cfg.with_constant else zero
    )
    d_params = KernelParams(
        log_length_scale=d_log_ls, log_noise=d_log_noise, log_constant=d_log_constant
    )
    # dLML/dy = -K^{-1} y; dLML/d(jitter) = tr(G). D2 is a fit constant (its
    # cotangent is dead code in every caller and DCE'd).
    return (d_params, jnp.zeros_like(D2), -g * alpha, g * jnp.trace(G))


log_marginal_likelihood_matmul.defvjp(_lml_matmul_fwd, _lml_matmul_bwd)


@struct.dataclass
class GPPosterior:
    """Cached factorization for fast batched prediction.

    ``Kinv`` is materialized (not just L) so the per-sample predictive variance
    k** - k*^T Kinv k* is a pure batched matmul in the MCMC hot loop.
    """

    params: KernelParams
    X: jax.Array          # (N, d) training inputs
    alpha: jax.Array      # (N,)   K^-1 y
    Kinv: jax.Array       # (N, N)
    prior_var: jax.Array  # ()     kernel.diag value (constant for stationary kernels)
    lml: jax.Array        # ()     LML at the fitted hyperparameters


def posterior_from_params(
    cfg: KernelConfig,
    params: KernelParams,
    X: jax.Array,
    y: jax.Array,
    alpha_jitter: float,
) -> GPPosterior:
    K = train_gram(cfg, params, X, alpha_jitter)
    L = jnp.linalg.cholesky(K)
    alpha = jax.scipy.linalg.cho_solve((L, True), y)
    n = y.shape[0]
    lml = -0.5 * (y @ alpha) - jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * n * _LOG_2PI
    Kinv = jax.scipy.linalg.cho_solve((L, True), jnp.eye(n, dtype=K.dtype))
    return GPPosterior(
        params=params,
        X=X,
        alpha=alpha,
        Kinv=Kinv,
        prior_var=prior_variance(cfg, params, dtype=K.dtype),
        lml=lml,
    )


def posterior_from_params_matmul(
    cfg: KernelConfig,
    params: KernelParams,
    X: jax.Array,
    y: jax.Array,
    alpha_jitter: float,
) -> GPPosterior:
    """posterior_from_params via the blocked matmul-only factorization.

    Same contract and (up to fp reordering) same values; used by the fit when
    lml_impl='matmul' so the final posterior build shares its factorization.
    vmap-safe (chol_inv_batched collapses the stacked-PC axis into its
    batch).
    """
    from bayesian_inference_tpu.ops.blocked_cholesky import chol_inv_batched

    hi = jax.lax.Precision.HIGHEST
    K = train_gram(cfg, params, X, alpha_jitter)
    invL, half_logdet = chol_inv_batched(K[None])
    invL, half_logdet = invL[0], half_logdet[0]
    Kinv = jnp.einsum("ki,kj->ij", invL, invL, precision=hi)
    alpha = jnp.einsum("ij,j->i", Kinv, y, precision=hi)
    n = y.shape[0]
    lml = -0.5 * (y @ alpha) - half_logdet - 0.5 * n * _LOG_2PI
    return GPPosterior(
        params=params,
        X=X,
        alpha=alpha,
        Kinv=Kinv,
        prior_var=prior_variance(cfg, params, dtype=K.dtype),
        lml=lml,
    )


def predict(cfg: KernelConfig, post: GPPosterior, theta: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Posterior mean and variance at ``theta`` (B, d) for one GP -> ((B,), (B,)).

    vmap over stacked GPPosterior for the all-PCs version.
    """
    ks = cross_covariance(cfg, post.params, theta, post.X)  # (B, N)
    mean = ks @ post.alpha
    var = post.prior_var - jnp.sum((ks @ post.Kinv) * ks, axis=-1)
    return mean, jnp.maximum(var, 0.0)


def predict_all(cfg: KernelConfig, posts: GPPosterior, theta: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched over stacked GPs: posts has leading axis k; returns ((B, k), (B, k))."""
    mean, var = jax.vmap(lambda p: predict(cfg, p, theta))(posts)
    return mean.T, var.T


def predict_all_shared(
    cfg: KernelConfig, posts: GPPosterior, theta: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """predict_all for stacked GPs sharing one training-input set.

    The per-dimension squared differences (B, N, ndim) are identical for every
    PC — only the length-scale contraction differs — so they are computed ONCE
    and contracted per PC as an einsum (the same shared-sqdiff trick the fit
    objective uses, ops/gram.py:69-86). vmap(predict) instead materializes a
    (k, B, N, ndim) difference tensor through HBM every sampler step; at the
    production shapes (41 PCs x 50 walkers x 200 design points) this path cuts
    that traffic ~ndim*k-fold. Identical math to predict_all modulo summation
    order (guarded by a parity test).

    Requires identical posts.X across the stacked axis (all PCs of an
    emulation group share the design matrix; build_likelihood's group fusion
    preserves this).
    """
    X = posts.X[0]  # (N, d), shared across the stacked axis
    diff = theta[:, None, :] - X[None, :, :]          # (B, N, d) — PC-independent
    D2 = diff * diff
    w = jnp.exp(-2.0 * posts.params.log_length_scale)  # (k, d) = 1/ls^2
    # Distance precision feeds the Cholesky-solved alpha/Kinv contractions;
    # keep the d-contraction at HIGHEST like _sqdist_from_sqdiff.
    sq = jnp.einsum("bnd,kd->kbn", D2, w, precision=jax.lax.Precision.HIGHEST)
    from bayesian_inference_tpu.ops.gram import matern_from_sqdist

    ks = matern_from_sqdist(sq, cfg.nu)               # (k, B, N)
    if cfg.with_constant:
        ks = ks + jnp.exp(posts.params.log_constant)[:, None, None]
    mean = jnp.einsum("kbn,kn->bk", ks, posts.alpha)
    t = jnp.einsum("kbn,knm->kbm", ks, posts.Kinv)
    var = posts.prior_var[None, :] - jnp.einsum("kbn,kbn->bk", t, ks)
    return mean, jnp.maximum(var, 0.0)


# Jitted wrappers for host-facing (eager) callers: setup factorizations and
# batch predictions each run as a single compiled program, not as a chain of
# eager dispatches.
posterior_from_params_jit = jax.jit(posterior_from_params)
posteriors_from_params_stacked = jax.jit(
    lambda cfg, params, X, Y_cols, alpha_jitter: jax.vmap(
        lambda p, y: posterior_from_params(cfg, p, X, y, alpha_jitter)
    )(params, Y_cols)
)
predict_all_jit = jax.jit(predict_all)
