"""Blocked Cholesky inverse + matmul-only LML: parity vs numpy and autodiff.

These pin the "matmul" fit implementation (ops/blocked_cholesky +
gp.log_marginal_likelihood_matmul).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_inference_tpu.models import gp as gp_mod
from bayesian_inference_tpu.models.gp_fit import GPFitSpec, fit_gps, spec_from_reference_config
from bayesian_inference_tpu.ops.blocked_cholesky import blocked_chol_inv, chol_inv_batched
from bayesian_inference_tpu.ops.gram import KernelConfig, KernelParams, pairwise_sqdiff

rng = np.random.default_rng(7)


def _spd(B, N):
    A = rng.normal(size=(B, N, N))
    return A @ np.swapaxes(A, -1, -2) / N + 2.0 * np.eye(N)


@pytest.mark.parametrize("B,N", [(3, 64), (2, 200)])
def test_blocked_chol_inv_matches_numpy(B, N):
    K = _spd(B, N)
    invL, hld = blocked_chol_inv(jnp.asarray(K))
    L_ref = np.linalg.cholesky(K)
    np.testing.assert_allclose(np.asarray(invL), np.linalg.inv(L_ref), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(hld), np.log(np.diagonal(L_ref, axis1=-2, axis2=-1)).sum(-1), rtol=1e-10
    )


def test_chol_inv_batched_collapses_nested_vmaps():
    """Nested vmaps must fold into one lane batch, not lift the kernel per
    instance, and still match the plain batched call."""
    K = jnp.asarray(_spd(6, 64))
    ref_invL, ref_hld = blocked_chol_inv(K)
    out_invL, out_hld = jax.vmap(jax.vmap(lambda k: chol_inv_batched(k[None])))(
        K.reshape(2, 3, 64, 64)
    )
    np.testing.assert_allclose(
        np.asarray(out_invL).reshape(6, 1, 64, 64)[:, 0], np.asarray(ref_invL), rtol=1e-12
    )
    np.testing.assert_allclose(np.asarray(out_hld).reshape(6), np.asarray(ref_hld), rtol=1e-12)


@pytest.mark.parametrize("nu,with_constant", [(1.5, False), (2.5, True), (0.5, False), (None, False)])
def test_lml_matmul_matches_autodiff(nu, with_constant):
    """Value AND gradient parity of the matmul-only LML vs the autodiff path,
    across every kernel family."""
    N, d = 32, 6
    X = rng.uniform(0.0, 1.0, (N, d))
    D2 = pairwise_sqdiff(jnp.asarray(X))
    y = jnp.asarray(rng.normal(size=N))
    cfg = KernelConfig(nu=nu, with_noise=True, with_constant=with_constant)
    params = KernelParams.create(
        length_scale=rng.uniform(0.5, 2.0, d), noise=0.3, constant=1.7
    )

    val_ref, grad_ref = jax.value_and_grad(
        lambda p: gp_mod.log_marginal_likelihood_sqdiff(cfg, p, D2, y, 1e-6)
    )(params)
    val, grad = jax.value_and_grad(
        lambda p: gp_mod.log_marginal_likelihood_matmul(cfg, p, D2, y, 1e-6)
    )(params)

    np.testing.assert_allclose(float(val), float(val_ref), rtol=1e-10)
    for leaf, leaf_ref in zip(jax.tree.leaves(grad), jax.tree.leaves(grad_ref)):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(leaf_ref), rtol=1e-8, atol=1e-10)


def test_posterior_from_params_matmul_matches():
    N, d = 48, 6
    X = jnp.asarray(rng.uniform(0.0, 1.0, (N, d)))
    y = jnp.asarray(rng.normal(size=N))
    cfg = KernelConfig(nu=1.5, with_noise=True)
    params = KernelParams.create(length_scale=rng.uniform(0.5, 2.0, d), noise=0.2)
    ref = gp_mod.posterior_from_params(cfg, params, X, y, 1e-6)
    out = gp_mod.posterior_from_params_matmul(cfg, params, X, y, 1e-6)
    np.testing.assert_allclose(np.asarray(out.alpha), np.asarray(ref.alpha), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.Kinv), np.asarray(ref.Kinv), rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(float(out.lml), float(ref.lml), rtol=1e-12)


@pytest.mark.slow
def test_fit_gps_matmul_impl_matches_autodiff():
    """End-to-end fit with lml_impl='matmul' must land on the same optima as
    the autodiff implementation (identical trajectories up to fp noise)."""
    N, d, k = 30, 6, 2
    X = rng.uniform(0.0, 1.0, (N, d))
    Y = rng.normal(size=(N, k))
    base = dict(
        cfg=KernelConfig(nu=1.5, with_noise=True),
        param_min=np.zeros(d),
        param_max=np.ones(d),
        n_restarts=3,
        n_iters=12,
        alpha_jitter=1e-6,
        dtype=jnp.float64,
    )
    spec_a = spec_from_reference_config(lml_impl="autodiff", **base)
    spec_m = spec_from_reference_config(lml_impl="matmul", **base)
    assert spec_m.lml_impl == "matmul"
    posts_a = fit_gps(spec_a, jnp.asarray(X), jnp.asarray(Y), jax.random.key(0))
    posts_m = fit_gps(spec_m, jnp.asarray(X), jnp.asarray(Y), jax.random.key(0))
    np.testing.assert_allclose(np.asarray(posts_m.lml), np.asarray(posts_a.lml), rtol=1e-8)
    for leaf_m, leaf_a in zip(jax.tree.leaves(posts_m.params), jax.tree.leaves(posts_a.params)):
        np.testing.assert_allclose(np.asarray(leaf_m), np.asarray(leaf_a), rtol=1e-6, atol=1e-8)
