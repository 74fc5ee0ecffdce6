"""Batched small-matrix Cholesky + forward substitution, unrolled over columns.

For many tiny matrices, unrolling the column recurrence into n batch-wide
steps (one rsqrt + one rank-1 downdate over the whole (batch, n, n) tensor)
avoids a per-matrix factorization loop. This is the plain reference of the
fused block-MVN kernel (ops/pallas_mvn.py) and the route
ops.mvn.mvn_loglike_dense takes for trailing dimensions n <= 32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tiny_cholesky(A: jax.Array) -> jax.Array:
    """Cholesky of (..., n, n) SPD matrices, unrolled over the n columns.

    Left-looking with an explicit Schur-complement downdate: at step j, A holds
    the Schur complement of the trailing block; column j of L is
    A[:, j]/sqrt(A[j, j]) masked below the diagonal.
    """
    n = A.shape[-1]
    idx = jnp.arange(n)
    cols = []
    for j in range(n):
        inv_pivot = jax.lax.rsqrt(A[..., j, j])
        col = A[..., :, j] * inv_pivot[..., None]
        col = jnp.where(idx >= j, col, jnp.zeros_like(col))
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return jnp.stack(cols, axis=-1)


def tiny_solve_lower(L: jax.Array, b: jax.Array) -> jax.Array:
    """Forward substitution L y = b for (..., n, n) lower-triangular L, (..., n) b.

    Column-oriented: once y_i is known, its contribution L[:, i] * y_i is
    removed from the remaining right-hand side in one batch-wide op.
    """
    n = L.shape[-1]
    ys = []
    for i in range(n):
        y_i = b[..., i] / L[..., i, i]
        ys.append(y_i)
        b = b - L[..., :, i] * y_i[..., None]
    return jnp.stack(ys, axis=-1)


def tiny_mvn_loglike(dY: jax.Array, cov: jax.Array) -> jax.Array:
    """Unnormalized MVN loglike via the unrolled factorization (n <= ~32)."""
    L = tiny_cholesky(cov)
    e = tiny_solve_lower(L, dY)
    quad = jnp.sum(e * e, axis=-1)
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * quad - half_logdet
