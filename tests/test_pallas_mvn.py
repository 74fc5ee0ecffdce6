"""Fused block-MVN kernel (Pallas interpreter mode), its dispatch, and the
unrolled/dense MVN routes: parity vs scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_inference_tpu.ops.cholesky import tiny_cholesky, tiny_mvn_loglike, tiny_solve_lower
from bayesian_inference_tpu.ops.mvn import build_woodbury, mvn_loglike_dense, woodbury_loglike
from bayesian_inference_tpu.ops.pallas_mvn import (
    MAX_KERNEL_NB,
    composed_block_mvn_loglike,
    fused_block_mvn_loglike,
    kernel_tile,
)

rng = np.random.default_rng(3)


def _random_blocks(W, B, nb):
    A = rng.normal(size=(W, B, nb, nb))
    C = A @ np.swapaxes(A, -1, -2) / nb + 2.0 * np.eye(nb)
    dY = rng.normal(size=(W, B, nb))
    return dY, C


def _scipy_ref(dY, C):
    from scipy.linalg import cholesky, solve_triangular

    W, B, nb = dY.shape
    out = np.zeros((W, B))
    for w in range(W):
        for b in range(B):
            L = cholesky(C[w, b], lower=True)
            e = solve_triangular(L, dY[w, b], lower=True)
            out[w, b] = -0.5 * e @ e - np.log(np.diag(L)).sum()
    return out


def test_tiny_cholesky_matches_numpy():
    _, C = _random_blocks(3, 4, 13)
    L = np.asarray(tiny_cholesky(jnp.asarray(C)))
    ref = np.linalg.cholesky(C)
    np.testing.assert_allclose(L, ref, rtol=1e-9, atol=1e-12)


def test_tiny_solve_lower():
    _, C = _random_blocks(2, 3, 9)
    L = np.linalg.cholesky(C)
    b = rng.normal(size=(2, 3, 9))
    y = np.asarray(tiny_solve_lower(jnp.asarray(L), jnp.asarray(b)))
    np.testing.assert_allclose(np.einsum("wbij,wbj->wbi", L, y), b, rtol=1e-9, atol=1e-10)


def test_tiny_mvn_loglike_matches_scipy():
    dY, C = _random_blocks(4, 5, 17)
    ours = np.asarray(tiny_mvn_loglike(jnp.asarray(dY), jnp.asarray(C)))
    np.testing.assert_allclose(ours, _scipy_ref(dY, C), rtol=1e-9)


def test_woodbury_capacitance_matches_scipy():
    """Lowrank route: the Woodbury capacitance solve reproduces the dense
    (F, F) covariance loglike computed with scipy."""
    from scipy.linalg import cho_factor, cho_solve

    F, k, W = 23, 6, 5
    A = rng.normal(size=(F, F))
    D = A @ A.T / F + np.eye(F)
    U = rng.normal(size=(F, k)) / np.sqrt(k)
    d0 = rng.normal(size=F)
    z = rng.normal(size=(W, k))
    v = rng.uniform(0.1, 1.0, size=(W, k))
    wn = build_woodbury(jnp.asarray(D), jnp.asarray(U), jnp.asarray(d0))
    ours = np.asarray(woodbury_loglike(wn, jnp.asarray(z), jnp.asarray(v)))
    ref = []
    for w in range(W):
        C = D + (U * v[w]) @ U.T
        dY = d0 + U @ z[w]
        c = cho_factor(C, lower=True)
        ref.append(-0.5 * dY @ cho_solve(c, dY) - np.log(np.diag(c[0])).sum())
    np.testing.assert_allclose(ours, ref, rtol=1e-9)


@pytest.mark.parametrize("nb", [8, 40])
def test_mvn_loglike_dense_matches_scipy(nb):
    """Both routes of mvn_loglike_dense: the unrolled factorization (n <= 32)
    and XLA's batched Cholesky (wider blocks)."""
    dY, C = _random_blocks(2, 3, nb)
    out = np.asarray(mvn_loglike_dense(jnp.asarray(dY), jnp.asarray(C)))
    np.testing.assert_allclose(out, _scipy_ref(dY, C), rtol=1e-9)


def _random_fused(W, B, nb, k, seed=5):
    r = np.random.default_rng(seed)
    U = r.normal(size=(B, nb, k)) / np.sqrt(k)
    A = r.normal(size=(B, nb, nb))
    D = A @ np.swapaxes(A, -1, -2) / nb + 2.0 * np.eye(nb)
    d0 = r.normal(size=(B, nb))
    z = r.normal(size=(W, k))
    v = r.uniform(0.1, 1.0, size=(W, k))
    return U, D, d0, z, v


def _fused_ref(U, D, d0, z, v):
    dY = d0 + np.einsum("bfk,wk->wbf", U, z)
    C = D + np.einsum("bfk,wk,bgk->wbfg", U, v, U)
    return _scipy_ref(dY, C).sum(axis=1)


def _kernel(args, dtype=None):
    return np.asarray(
        fused_block_mvn_loglike(*(jnp.asarray(a, dtype) for a in args), interpret=True)
    )


def test_fused_block_mvn_interpret_matches_scipy():
    """Fused kernel (assembly + Cholesky + loglike) in interpreter mode,
    including a non-power-of-two block width (nb=11 runs padded to 16) and a
    partial walker tile (37 walkers)."""
    args = _random_fused(W=37, B=4, nb=11, k=9)
    np.testing.assert_allclose(_kernel(args), _fused_ref(*args), rtol=1e-8)


def test_fused_block_mvn_vmap_over_d0():
    """The closure-test batch vmaps the likelihood over per-point residual
    offsets; the pallas batching rule must handle a mapped d0 with broadcast
    U/D (interpret mode exercises the same rule the CUDA path uses)."""
    U, D, d0, z, v = _random_fused(W=5, B=3, nb=9, k=7)
    P = 4
    d0_batch = np.stack([d0 * (1 + 0.1 * p) for p in range(P)])
    out = jax.vmap(
        lambda d: fused_block_mvn_loglike(
            jnp.asarray(U), jnp.asarray(D), d, jnp.asarray(z), jnp.asarray(v),
            interpret=True,
        )
    )(jnp.asarray(d0_batch))
    ref = np.stack([_fused_ref(U, D, d0_batch[p], z, v) for p in range(P)])
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8)


def test_fused_block_mvn_interpret_production_widths():
    """The production bucket widths at the half-ensemble walker count (W=50):
    nb=24 pads to 32 with 4 walkers per program, i.e. 13 walker tiles, the
    last one partial."""
    args = _random_fused(W=50, B=3, nb=24, k=9)
    assert kernel_tile(24, 50) == (32, 4)
    np.testing.assert_allclose(_kernel(args), _fused_ref(*args), rtol=1e-8)


@pytest.mark.parametrize("W,nb,tile", [(16, 7, (8, 16)), (13, 16, (16, 16)), (100, 8, (8, 64))])
def test_fused_block_mvn_walker_tiles(W, nb, tile):
    """Walker tiles: a tile wider than the batch (masked walkers), an exact
    tile, and several tiles; the tile keeps walkers x nbp^2 at the register
    budget."""
    assert kernel_tile(nb, W) == tile
    args = _random_fused(W=W, B=5, nb=nb, k=6, seed=11 + W)
    np.testing.assert_allclose(_kernel(args), _fused_ref(*args), rtol=1e-8)


def test_fused_block_mvn_dispatch_cpu_path():
    U, D, d0, z, v = _random_fused(W=6, B=3, nb=7, k=5)
    auto = np.asarray(
        fused_block_mvn_loglike(*(jnp.asarray(a) for a in (U, D, d0, z, v)))
    )
    np.testing.assert_allclose(auto, _fused_ref(U, D, d0, z, v), rtol=1e-9)


def test_fused_block_mvn_float32_tolerance():
    """The kernel's precision contract: float32 FMA arithmetic ("ieee", no
    tensor-core pass) stays within 2e-5 relative of the float64 reference at
    a production-like width."""
    args = _random_fused(W=50, B=5, nb=16, k=41, seed=73)
    out = _kernel(args, jnp.float32)
    np.testing.assert_allclose(out, _fused_ref(*args), rtol=2e-5)


@pytest.mark.parametrize("nb", [MAX_KERNEL_NB, MAX_KERNEL_NB + 8])
def test_wide_blocks_take_dense_route_on_cuda(nb):
    """Stated shape rule: blocks wider than MAX_KERNEL_NB lower to XLA's dense
    factorization on CUDA too, never silently; narrower ones to the kernel."""
    shapes = [(2, nb, 5), (2, nb, nb), (2, nb), (50, 5), (50, 5)]
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    with jax.enable_x64(False):
        text = jax.jit(fused_block_mvn_loglike).trace(*args).lower(
            lowering_platforms=("cuda",)
        ).as_text()
    assert ("__gpu$xla.gpu.triton" in text) == (nb <= MAX_KERNEL_NB)
    U, D, d0, z, v = _random_fused(W=3, B=2, nb=nb, k=5)
    out = np.asarray(fused_block_mvn_loglike(*(jnp.asarray(a) for a in (U, D, d0, z, v))))
    np.testing.assert_allclose(out, _fused_ref(U, D, d0, z, v), rtol=1e-9)


def test_composed_reference_matches_scipy():
    args = _random_fused(W=4, B=3, nb=13, k=5, seed=2)
    out = np.asarray(composed_block_mvn_loglike(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(out, _fused_ref(*args), rtol=1e-9)
