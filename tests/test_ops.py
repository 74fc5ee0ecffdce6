"""Parity tests: Gram kernels vs sklearn, MVN loglike vs scipy/LAPACK formula,
Woodbury identity vs the dense path."""

import numpy as np
import pytest

import jax.numpy as jnp

from bayesian_inference_tpu.ops import (
    KernelConfig,
    KernelParams,
    build_woodbury,
    cross_covariance,
    mvn_loglike_dense,
    prior_variance,
    train_gram,
    woodbury_loglike,
)

rng = np.random.default_rng(42)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, None])
def test_gram_matches_sklearn(nu):
    import sklearn.gaussian_process.kernels as skk

    X1 = rng.uniform(0, 2, (17, 4))
    X2 = rng.uniform(0, 2, (9, 4))
    ls = rng.uniform(0.3, 3.0, 4)
    if nu is None:
        sk = skk.RBF(length_scale=ls)
    else:
        sk = skk.Matern(length_scale=ls, nu=nu)

    cfg = KernelConfig(nu=nu, with_noise=False, with_constant=False)
    params = KernelParams.create(ls)
    ours = np.asarray(cross_covariance(cfg, params, jnp.asarray(X1), jnp.asarray(X2)))
    np.testing.assert_allclose(ours, sk(X1, X2), rtol=1e-12, atol=1e-12)


def test_gram_with_noise_and_constant_matches_sklearn():
    import sklearn.gaussian_process.kernels as skk

    X = rng.uniform(0, 2, (13, 3))
    ls = rng.uniform(0.3, 3.0, 3)
    noise, const = 0.25, 1.7
    sk = skk.Matern(length_scale=ls, nu=1.5) + skk.ConstantKernel(const) + skk.WhiteKernel(noise)

    cfg = KernelConfig(nu=1.5, with_noise=True, with_constant=True)
    params = KernelParams.create(ls, noise=noise, constant=const)

    # training gram includes noise on the diagonal
    ours = np.asarray(train_gram(cfg, params, jnp.asarray(X)))
    np.testing.assert_allclose(ours, sk(X), rtol=1e-12, atol=1e-12)
    # cross covariance excludes noise
    ours_cross = np.asarray(cross_covariance(cfg, params, jnp.asarray(X), jnp.asarray(X[:5])))
    np.testing.assert_allclose(ours_cross, sk(X, X[:5]), rtol=1e-12, atol=1e-12)
    # prior variance matches kernel.diag
    np.testing.assert_allclose(float(prior_variance(cfg, params)), sk.diag(X)[0], rtol=1e-12)


def _random_spd(F, strength=1.0):
    A = rng.normal(size=(F, F))
    return A @ A.T / F + strength * np.eye(F)


def test_mvn_loglike_dense_matches_lapack_formula():
    from scipy.linalg import cholesky, cho_solve

    B, F = 7, 23
    dY = rng.normal(size=(B, F))
    covs = np.stack([_random_spd(F) for _ in range(B)])

    ours = np.asarray(mvn_loglike_dense(jnp.asarray(dY), jnp.asarray(covs)))

    for i in range(B):
        L = cholesky(covs[i], lower=True)
        alpha = cho_solve((L, True), dY[i])
        ref = -0.5 * dY[i] @ alpha - np.sum(np.log(np.diag(L)))
        np.testing.assert_allclose(ours[i], ref, rtol=1e-10)


def test_woodbury_matches_dense():
    B, F, k = 11, 40, 6
    D = _random_spd(F, strength=0.5)
    U = rng.normal(size=(F, k))
    d0 = rng.normal(size=F)
    z = rng.normal(size=(B, k))
    v = rng.uniform(0.1, 2.0, size=(B, k))

    wn = build_woodbury(jnp.asarray(D), jnp.asarray(U), jnp.asarray(d0))
    ours = np.asarray(woodbury_loglike(wn, jnp.asarray(z), jnp.asarray(v)))

    # dense reference: C = D + U diag(v) U^T, residual = d0 + U z
    dY = d0[None, :] + z @ U.T
    covs = np.stack([D + (U * v[i]) @ U.T for i in range(B)])
    ref = np.asarray(mvn_loglike_dense(jnp.asarray(dY), jnp.asarray(covs)))
    np.testing.assert_allclose(ours, ref, rtol=1e-9)


def test_woodbury_single_sample_shape():
    F, k = 20, 3
    D = _random_spd(F)
    U = rng.normal(size=(F, k))
    d0 = rng.normal(size=F)
    wn = build_woodbury(jnp.asarray(D), jnp.asarray(U), jnp.asarray(d0))
    out = woodbury_loglike(wn, jnp.zeros(k), jnp.ones(k))
    assert out.shape == ()


def test_flops_accounting_hand_count():
    """utils/flops counts audited against a hand computation on tiny shapes
    (the bench's MFU numbers are only as defensible as these formulas)."""
    from types import SimpleNamespace

    from bayesian_inference_tpu.utils import flops

    # one group: k=2 PCs, N=3 design points, d=2 dims; one bucket: 1 block, nb=2, k=2
    like = SimpleNamespace(
        groups=[SimpleNamespace(posts=SimpleNamespace(X=np.zeros((2, 3, 2))))],
        U=[np.zeros((1, 2, 2))],
    )
    W = 4
    gp = W * (2 * 3 * (3 * 2 + 8) + 2 * 2 * 3 + 2 * 2 * 3 * 3 + 2 * 2 * 3)
    k1 = 3
    blocks = W * 1 * (2 * 2 * k1 + 2 * 4 * k1 + 8 + 4 * 4)
    assert flops.mcmc_step_flops(like, W) == gp + blocks
    # scales linearly in walkers
    assert flops.mcmc_step_flops(like, 2 * W) == 2 * (gp + blocks)

    # lowrank mode: the Woodbury k x k capacitance route replaces the blocks
    like_lr = SimpleNamespace(
        groups=like.groups,
        U=like.U,
        mode="lowrank",
        wb=SimpleNamespace(G=np.zeros((2, 2))),
    )
    woodbury = W * (5 * 4 + 2 * (8 + 4 * 4))
    assert flops.mcmc_step_flops(like_lr, W) == gp + woodbury

    # fit schedule: R=3 instances x (halving_iters+1) + keep x remaining + posterior
    per_iter = flops.fit_iteration_flops(N=10, d=2)
    total = flops.fit_total_flops(
        N=10, d=2, k_pcs=2, n_restarts=2, n_iters=5, halving_iters=2, halving_keep=1
    )
    assert total == 2 * 3 * 3 * per_iter + 2 * 1 * 3 * per_iter + 2 * 3 * 1000
    # no halving when keep=0
    total_nh = flops.fit_total_flops(
        N=10, d=2, k_pcs=2, n_restarts=2, n_iters=5, halving_iters=2, halving_keep=0
    )
    assert total_nh == 2 * 3 * 6 * per_iter + 2 * 3 * 1000

    # H100 SXM peaks by device_kind
    h100 = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
    assert flops.device_peaks(h100) == {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "fp32_tflops": 67.0, "hbm_tbps": 3.35,
    }
    assert flops.device_peak_tflops(h100) == 989.0


def test_device_peaks_unknown_kind_raises():
    from types import SimpleNamespace

    from bayesian_inference_tpu.utils import flops

    with pytest.raises(KeyError, match="no published peaks"):
        flops.device_peaks(SimpleNamespace(device_kind="Some Other Accelerator"))
