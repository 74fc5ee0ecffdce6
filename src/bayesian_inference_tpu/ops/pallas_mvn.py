"""Fused block-MVN log-likelihood: a Pallas kernel for NVIDIA GPUs.

THE hot op of the MCMC loop. For every (walker, observable block) pair the
block-mode likelihood (mcmc/likelihood.py) needs

    dY = d0 + U z                C = D + U diag(v) U^T
    ll = -1/2 ||L^{-1} dY||^2 - sum(log diag L),   C = L L^T

with U (nb, k), D (nb, nb), d0 (nb,) constant per block and z, v (k,) the
walker's emulator PC means and variances. Summed over blocks it gives the
walker's log-likelihood.

The plain XLA version (``composed_block_mvn_loglike``) materializes the
(W, n_obs, nb, nb) covariance tensor in device memory and factors it with
ops/mvn.mvn_loglike_dense: for nb <= 32 the unrolled column recurrence of
ops/cholesky.tiny_mvn_loglike, a chain of XLA fusions, else XLA's Cholesky. The kernel (``_fused_kernel``) does assembly, factorization, forward
substitution and log-determinant in registers, one program per (observable
block, walker tile):

  C, b   = D, d0                               (bw, nbp, nbp), (bw, nbp)
  per PC k:      C += v[:, k] * U[:, k] U[:, k]^T ; b += z[:, k] * U[:, k]
  per column j:  col = C[:, :, j] / sqrt(C[:, j, j])   masked below-diagonal
                 y_j = b[:, j] / sqrt(C[:, j, j]) ; b -= col * y_j
                 quad += y_j^2 ; half_logdet += log(C[:, j, j]) / 2
                 C -= col col^T                     (rank-1 Schur downdate)

All arithmetic is float32 fused multiply-adds on the CUDA cores ("ieee"
precision): no tensor-core pass, so no TF32 rounding anywhere in the kernel.
Triton needs power-of-two tensor sizes, so a block of width nb runs at
nbp = next_power_of_2(nb) with masked loads: the padded rows and columns hold
an identity covariance and a zero residual and contribute exactly 0.

Dispatch is by lowering platform: the kernel on CUDA, the composed XLA path
everywhere else (the CPU tests' reference). One stated shape rule holds on
every platform: blocks wider than ``MAX_KERNEL_NB`` take the composed XLA
path, because the kernel keeps a whole padded block per walker in registers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bayesian_inference_tpu.ops.mvn import mvn_loglike_dense

# Widest observable block the kernel takes (pads to 64: one walker per program).
MAX_KERNEL_NB = 48
# Register budget of one program: walkers x padded block elements.
_TILE_ELEMS = 4096
_NUM_WARPS = 4


def padded_width(nb: int) -> int:
    """The width the kernel runs an nb-wide block at (Triton: a power of two)."""
    return pl.next_power_of_2(nb)


def kernel_tile(nb: int, n_walkers: int) -> tuple[int, int]:
    """(nbp, bw): the padded block width and the walkers per program."""
    nbp = padded_width(nb)
    bw = max(1, min(pl.next_power_of_2(n_walkers), _TILE_ELEMS // (nbp * nbp)))
    return nbp, bw


def composed_block_mvn_loglike(U, D, d0, z, v) -> jax.Array:
    """Plain XLA reference: (n_obs,nb,k),(n_obs,nb,nb),(n_obs,nb),(W,k),(W,k) -> (W,)."""
    dY = d0 + jnp.einsum("bfk,wk->wbf", U, z)
    C = D + jnp.einsum("bfk,wk,bgk->wbfg", U, v, U)
    return jnp.sum(mvn_loglike_dense(dY, C), axis=-1)


def _fused_kernel(nb, nbp, bw, u_ref, d_ref, d0_ref, z_ref, v_ref, out_ref):
    i = pl.program_id(0)
    n_walkers, k = z_ref.shape
    w = pl.program_id(1) * bw + jnp.arange(bw)
    w_ok = w < n_walkers
    f = jnp.arange(nbp)
    f_ok = f < nb
    dt = out_ref.dtype

    # Masked loads: padded rows/columns read as 0, the padded diagonal as 1.
    D = plgpu.load(
        d_ref.at[i, f[:, None], f[None, :]],
        mask=f_ok[:, None] & f_ok[None, :], other=0.0,
    )
    D = D + jnp.where((f[:, None] == f[None, :]) & ~f_ok[:, None], 1.0, 0.0).astype(dt)
    C = jnp.broadcast_to(D[None], (bw, nbp, nbp))
    b = jnp.broadcast_to(plgpu.load(d0_ref.at[i, f], mask=f_ok, other=0.0)[None], (bw, nbp))

    def assemble(kk, carry):
        C, b = carry
        u = plgpu.load(u_ref.at[i, f, kk], mask=f_ok, other=0.0)       # (nbp,)
        zk = plgpu.load(z_ref.at[w, kk], mask=w_ok, other=0.0)          # (bw,)
        vk = plgpu.load(v_ref.at[w, kk], mask=w_ok, other=1.0)
        uu = u[:, None] * u[None, :]
        return C + vk[:, None, None] * uu[None], b + zk[:, None] * u[None, :]

    C, b = jax.lax.fori_loop(0, k, assemble, (C, b))

    g3 = jax.lax.broadcasted_iota(jnp.int32, (bw, nbp, nbp), 2)
    f2 = jax.lax.broadcasted_iota(jnp.int32, (bw, nbp), 1)

    def sweep(j, carry):
        C, b, quad, half_logdet = carry
        col = jnp.sum(jnp.where(g3 == j, C, 0.0), axis=2)                 # (bw, nbp)
        pivot = jnp.sum(jnp.where(f2 == j, col, 0.0), axis=1)             # (bw,)
        inv_p = jax.lax.rsqrt(pivot)
        col = jnp.where(f2 >= j, col * inv_p[:, None], 0.0)
        y_j = jnp.sum(jnp.where(f2 == j, b, 0.0), axis=1) * inv_p
        b = b - col * y_j[:, None]
        C = C - col[:, :, None] * col[:, None, :]
        return C, b, quad + y_j * y_j, half_logdet + 0.5 * jnp.log(pivot)

    zero = jnp.zeros((bw,), dt)
    _, _, quad, half_logdet = jax.lax.fori_loop(0, nb, sweep, (C, b, zero, zero))
    plgpu.store(out_ref.at[i, w], -0.5 * quad - half_logdet, mask=w_ok)


@functools.partial(jax.jit, static_argnames=("interpret",))
def fused_block_mvn_kernel(U, D, d0, z, v, interpret: bool = False) -> jax.Array:
    """Per-block log-likelihoods (n_obs, W) from the Triton kernel."""
    n_obs, nb, _ = U.shape
    W = z.shape[0]
    nbp, bw = kernel_tile(nb, W)
    return pl.pallas_call(
        functools.partial(_fused_kernel, nb, nbp, bw),
        grid=(n_obs, pl.cdiv(W, bw)),
        out_shape=jax.ShapeDtypeStruct((n_obs, W), z.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="fused_block_mvn",
    )(U, D, d0, z, v)


def fused_block_mvn_loglike(
    U: jax.Array,
    D: jax.Array,
    d0: jax.Array,
    z: jax.Array,
    v: jax.Array,
    interpret: bool = False,
) -> jax.Array:
    """Block-likelihood from emulator PC predictions.

    Inputs: padded block tensors U (n_obs, nb, k), D (n_obs, nb, nb),
    d0 (n_obs, nb) — see mcmc/likelihood.build_likelihood — and per-walker PC
    means/variances z, v (W, k). Returns (W,) log-likelihoods summed over
    observables; padded rows carry identity/zero blocks contributing 0.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on a
    host without a card); otherwise the lowering platform picks the kernel on
    CUDA and the composed XLA path elsewhere.
    """
    nb = U.shape[1]
    if nb > MAX_KERNEL_NB:
        return composed_block_mvn_loglike(U, D, d0, z, v)

    def kernel(U, D, d0, z, v):
        return jnp.sum(fused_block_mvn_kernel(U, D, d0, z, v, interpret=interpret), axis=0)

    if interpret:
        return kernel(U, D, d0, z, v)
    return jax.lax.platform_dependent(
        U, D, d0, z, v, cuda=kernel, default=composed_block_mvn_loglike
    )
