"""Batched blocked Cholesky + triangular inverse, built for the GP-fit batch.

The fit objective factorizes thousands of (N, N) kernel matrices per L-BFGS
iteration (N ~ 230 design points, batch ~ 2,000 PC x restart instances;
reference counterpart: sklearn GPR's L-BFGS restarts over LAPACK,
emulation.py:164-178). This module is the "matmul" implementation of that
objective (models/gp.log_marginal_likelihood_matmul): a blocked factorization
whose panels are batched matrix products, plus one batched Cholesky and
triangular inverse of each NB x NB diagonal block:

  blocked factorization, per panel k:
      L[k][k], invL[k][k] = chol, inverse(A[k][k])         (XLA batched)
      L[i][k]  = A[i][k] @ invL[k][k]^T                     (batched matmul)
      A[i][j] -= L[i][k] @ L[j][k]^T                        (batched matmul)
  block forward substitution for the full triangular inverse:
      invL[i][j] = -invL[i][i] @ sum_k L[i][k] @ invL[k][j] (batched matmul)

From invL, everything the log-marginal likelihood and its closed-form
gradient need is matmul work: alpha = invL^T (invL y), log|K| from the
diagonal blocks, K^{-1} = invL^T invL.

Panel matmuls run at the explicit ``precision`` argument — HIGHEST by
default, regardless of the ambient matmul precision: the trailing Schur
updates feed later pivots, and reduced-precision products break
positive-definiteness at this problem's conditioning (see the package
__init__ note on jax_default_matmul_precision). The GP fit's exploration
stage may lower it (GPFitSpec.explore_precision). Precision is an ARGUMENT
(part of every trace-cache key), not a context: jax caches custom_vjp/
custom_vmap traces by function identity + abstract args, so a trace-time
context would leak whichever precision traced first into later stages.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

_PRECISION_NAMES = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def precision_from_name(p):
    """jax.lax.Precision from its lowercase name (Precision values pass through)."""
    return _PRECISION_NAMES.get(p, p)


# Diagonal block size; N pads to a multiple (identity on the pad).
NB = 64


def _diag_chol_inv(A: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(B, nb, nb) SPD -> (L, invL) through XLA's batched Cholesky and
    triangular solve."""
    L = jnp.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    return L, jax.scipy.linalg.solve_triangular(L, eye, lower=True)


def blocked_chol_inv(K: jax.Array, precision=_HI) -> tuple[jax.Array, jax.Array]:
    """Batched (B, N, N) SPD -> (invL, half_logdet) with L K-factor inverse.

    N is padded internally to a multiple of NB with an identity diagonal pad
    (decoupled: the returned invL/half_logdet slice back exactly).

    Panel matmuls run at ``precision`` (HIGHEST default) — NEVER the ambient
    jax.default_matmul_precision: reduced-precision Schur updates feed later
    pivots and break positive-definiteness at this problem's conditioning
    (see the package __init__ note).
    """
    hi = precision_from_name(precision)
    B, N, _ = K.shape
    n_pad = (-N) % NB
    Np = N + n_pad
    if n_pad:
        Kp = jnp.zeros((B, Np, Np), K.dtype)
        Kp = Kp.at[:, :N, :N].set(K)
        Kp = Kp.at[:, N:, N:].set(jnp.eye(n_pad, dtype=K.dtype))
        K = Kp
    n = Np // NB

    # block grid of (B, NB, NB) arrays
    Ablk = [
        [K[:, i * NB : (i + 1) * NB, j * NB : (j + 1) * NB] for j in range(i + 1)]
        for i in range(n)
    ]
    L: list[list[jax.Array]] = [[None] * n for _ in range(n)]  # type: ignore[list-item]
    Inv: list[list[jax.Array]] = [[None] * n for _ in range(n)]  # type: ignore[list-item]
    half_logdet = jnp.zeros((B,), K.dtype)

    for k in range(n):
        Lkk, invLkk = _diag_chol_inv(Ablk[k][k])
        L[k][k], Inv[k][k] = Lkk, invLkk
        half_logdet = half_logdet + jnp.sum(
            jnp.log(jnp.diagonal(Lkk, axis1=-2, axis2=-1)), axis=-1
        )
        for i in range(k + 1, n):
            L[i][k] = jnp.einsum("bij,bkj->bik", Ablk[i][k], invLkk, precision=hi)
        for i in range(k + 1, n):
            for j in range(k + 1, i + 1):
                Ablk[i][j] = Ablk[i][j] - jnp.einsum(
                    "bik,bjk->bij", L[i][k], L[j][k], precision=hi
                )

    # Block forward substitution: invL[i][j] = -Inv[i][i] (sum_k L[i][k] Inv[k][j])
    for j in range(n):
        for i in range(j + 1, n):
            S = None
            for k in range(j, i):
                term = jnp.einsum("bik,bkj->bij", L[i][k], Inv[k][j], precision=hi)
                S = term if S is None else S + term
            Inv[i][j] = -jnp.einsum("bik,bkj->bij", Inv[i][i], S, precision=hi)

    zeros = jnp.zeros((B, NB, NB), K.dtype)
    invL = jnp.concatenate(
        [
            jnp.concatenate([Inv[i][j] if j <= i else zeros for j in range(n)], axis=2)
            for i in range(n)
        ],
        axis=1,
    )
    return invL[:, :N, :N], half_logdet


@functools.lru_cache(maxsize=None)
def _chol_inv_batched_for(precision):
    """Per-precision vmap-collapsing wrapper (precision must key the trace
    cache, so each precision gets its own custom_vmap instance)."""

    @jax.custom_batching.custom_vmap
    def chol_inv(K: jax.Array) -> tuple[jax.Array, jax.Array]:
        return blocked_chol_inv(K, precision=precision)

    @chol_inv.def_vmap
    def _chol_inv_vmap_rule(axis_size, in_batched, K):
        del axis_size
        (k_batched,) = in_batched
        assert k_batched, "chol_inv_batched vmapped with unbatched operand"
        V, B, N, _ = K.shape
        invL, hld = chol_inv(K.reshape(V * B, N, N))
        return (invL.reshape(V, B, N, N), hld.reshape(V, B)), (True, True)

    return chol_inv


def chol_inv_batched(K: jax.Array, precision=_HI) -> tuple[jax.Array, jax.Array]:
    """(B, N, N) SPD -> (invL (B, N, N), half_logdet (B,)); vmap-collapsing.

    The GP fit evaluates its objective under nested vmaps (instances x trial
    candidates). The batching rule folds any vmapped axis into the existing
    batch dimension and re-enters the same function, so arbitrarily nested
    vmaps all collapse into one batched factorization. ``precision`` sets the panel matmul fidelity
    (see blocked_chol_inv).
    """
    return _chol_inv_batched_for(precision_from_name(precision))(K)
