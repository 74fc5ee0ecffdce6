"""Stationary GP kernels (Matern / RBF + optional constant + white noise).

Differentiable jnp implementation used by the GP fit (gradients of the
log-marginal likelihood flow through these) and by the emulator predict path.
Semantics match sklearn.gaussian_process.kernels (reference emulation.py:132-162):

  - anisotropic (ARD) length scales: d(x,y) = ||(x - y)/ls||_2
  - Matern nu in {0.5, 1.5, 2.5}; nu=None means RBF (exp(-d^2/2))
  - ConstantKernel adds a constant everywhere (sum kernel)
  - WhiteKernel contributes noise_level * I on the training Gram and to the
    prior (diagonal) variance, but zero to cross-covariance

All functions vmap cleanly over a leading axis of ``KernelParams`` (one GP per
principal component).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from bayesian_inference_tpu.utils import struct


@struct.dataclass
class KernelConfig:
    """Static kernel structure (hashable; not traced)."""

    nu: float | None = struct.field(pytree_node=False, default=1.5)  # None => RBF
    with_noise: bool = struct.field(pytree_node=False, default=True)
    with_constant: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class KernelParams:
    """Log-space kernel hyperparameters, one GP's worth.

    Inactive fields (per KernelConfig) are carried as zeros and ignored.
    """

    log_length_scale: jax.Array  # (ndim,)
    log_noise: jax.Array         # ()  white-noise level (variance), log
    log_constant: jax.Array      # ()  constant kernel value, log

    @classmethod
    def create(cls, length_scale, noise=1.0, constant=1.0) -> "KernelParams":
        return cls(
            log_length_scale=jnp.log(jnp.asarray(length_scale)),
            log_noise=jnp.log(jnp.asarray(noise)),
            log_constant=jnp.log(jnp.asarray(constant)),
        )


def _scaled_sqdist(X1: jax.Array, X2: jax.Array, length_scale: jax.Array) -> jax.Array:
    """||(x-y)/ls||^2 for all pairs; (n1, n2).

    Computed from explicit differences. The matmul-friendly expansion
    a^2 + b^2 - 2ab suffers catastrophic cancellation in float32 when pair
    distances are small relative to coordinate magnitudes — at the fitted
    length scales of this problem that noise propagates through K^{-1}y into
    the GP mean and wrecks MCMC acceptance. ndim here is ~6, so the direct
    (n1, n2, ndim) broadcast is cheap and exact.
    """
    A = X1 / length_scale
    B = X2 / length_scale
    diff = A[:, None, :] - B[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def pairwise_sqdiff(X: jax.Array) -> jax.Array:
    """Per-dimension squared differences (x_ik - x_jk)^2; (n, n, ndim).

    Shared across every (PC, restart, linesearch-candidate) instance of the GP
    fit: the instance-specific scaled squared distance is the exact contraction
    ``einsum('ijk,k->ij', D2, 1/ls^2)``, so the fit's vmapped objective never
    materializes a (batch, n, n, ndim) tensor.
    """
    diff = X[:, None, :] - X[None, :, :]
    return diff * diff


def _sqdist_from_sqdiff(D2: jax.Array, length_scale: jax.Array) -> jax.Array:
    w = 1.0 / (length_scale * length_scale)
    # HIGHEST: this contraction must not drop to bf16 when callers lower the
    # ambient matmul precision for the exploration stage (distance precision
    # feeds the Cholesky; see _scaled_sqdist notes). ndim ~ 6 so it is cheap.
    return jnp.einsum("ijk,k->ij", D2, w, precision=jax.lax.Precision.HIGHEST)


def train_gram_from_sqdiff(
    cfg: KernelConfig, params: KernelParams, D2: jax.Array, alpha_jitter: float | jax.Array = 0.0
) -> jax.Array:
    """Training Gram from precomputed pairwise_sqdiff(X) (fit hot path)."""
    ls = jnp.exp(params.log_length_scale)
    K = matern_from_sqdist(_sqdist_from_sqdiff(D2, ls), cfg.nu)
    if cfg.with_constant:
        K = K + jnp.exp(params.log_constant)
    diag = jnp.asarray(alpha_jitter, K.dtype)
    if cfg.with_noise:
        diag = diag + jnp.exp(params.log_noise)
    return K + diag * jnp.eye(D2.shape[0], dtype=K.dtype)


def matern_from_sqdist(sq: jax.Array, nu: float | None) -> jax.Array:
    """Covariance from squared scaled distance. nu=None selects RBF."""
    if nu is None:
        return jnp.exp(-0.5 * sq)
    # sqrt is non-differentiable at 0; the usual guard keeps gradients finite
    # (the diagonal d=0 entries have zero gradient in exact arithmetic).
    d = jnp.sqrt(sq + 1e-36)
    if nu == 0.5:
        return jnp.exp(-d)
    if nu == 1.5:
        t = jnp.sqrt(3.0) * d
        return (1.0 + t) * jnp.exp(-t)
    if nu == 2.5:
        t = jnp.sqrt(5.0) * d
        return (1.0 + t + t * t / 3.0) * jnp.exp(-t)
    raise ValueError(f"Unsupported Matern nu={nu} (use 0.5, 1.5, 2.5, or None for RBF)")


def cross_covariance(cfg: KernelConfig, params: KernelParams, X1: jax.Array, X2: jax.Array) -> jax.Array:
    """k(X1, X2) without the white-noise term; (n1, n2)."""
    ls = jnp.exp(params.log_length_scale)
    K = matern_from_sqdist(_scaled_sqdist(X1, X2, ls), cfg.nu)
    if cfg.with_constant:
        K = K + jnp.exp(params.log_constant)
    return K


def train_gram(
    cfg: KernelConfig, params: KernelParams, X: jax.Array, alpha_jitter: float | jax.Array = 0.0
) -> jax.Array:
    """Full training Gram: k(X, X) + (noise_level + alpha) * I."""
    K = cross_covariance(cfg, params, X, X)
    diag = jnp.asarray(alpha_jitter, K.dtype)
    if cfg.with_noise:
        diag = diag + jnp.exp(params.log_noise)
    return K + diag * jnp.eye(X.shape[0], dtype=K.dtype)


def prior_variance(cfg: KernelConfig, params: KernelParams, dtype=jnp.float64) -> jax.Array:
    """kernel.diag(x) for any x: the prior variance used in predictive variance.

    Matern/RBF contribute 1, plus constant and white-noise terms when active
    (sklearn includes the WhiteKernel level in kernel.diag, hence in
    predict(return_std=True); GPR's alpha is excluded).
    """
    v = jnp.asarray(1.0, dtype)
    if cfg.with_constant:
        v = v + jnp.exp(params.log_constant)
    if cfg.with_noise:
        v = v + jnp.exp(params.log_noise)
    return v
