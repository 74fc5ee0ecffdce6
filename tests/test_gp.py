"""GP parity vs sklearn GaussianProcessRegressor on the real fixture."""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from bayesian_inference_tpu import io
from bayesian_inference_tpu.models import pca as pca_mod
from bayesian_inference_tpu.models import gp as gp_mod
from bayesian_inference_tpu.models import gp_fit
from bayesian_inference_tpu.ops.gram import KernelConfig, KernelParams

_data_dir = Path(__file__).parent / "test_data"


@pytest.fixture(scope="module")
def design_and_pcs():
    Y = io.predictions_matrix_from_h5(str(_data_dir), filename="observables.h5")
    design = io.design_array_from_h5(str(_data_dir), filename="observables.h5")
    _, Y_pca = pca_mod.fit_pca(Y)
    return np.asarray(design), np.asarray(Y_pca)


def _sk_gpr(ls, noise, X, y, optimize=False, n_restarts=0):
    import sklearn.gaussian_process as skg
    import sklearn.gaussian_process.kernels as skk

    kernel = skk.Matern(
        length_scale=ls, nu=1.5, length_scale_bounds=np.outer(ls, (0.01, 100.0))
    ) + skk.WhiteKernel(noise_level=noise, noise_level_bounds=(1e-4, 1.0))
    return skg.GaussianProcessRegressor(
        kernel=kernel,
        alpha=1e-10,
        optimizer="fmin_l_bfgs_b" if optimize else None,
        n_restarts_optimizer=n_restarts,
        copy_X_train=False,
    ).fit(X, y)


def test_lml_matches_sklearn(design_and_pcs):
    X, Y_pca = design_and_pcs
    y = Y_pca[:, 0]
    ls = X.max(axis=0) - X.min(axis=0)
    gpr = _sk_gpr(ls, 0.25, X, y, optimize=False)
    ref = gpr.log_marginal_likelihood_value_

    cfg = KernelConfig(nu=1.5, with_noise=True)
    params = KernelParams.create(ls, noise=0.25)
    ours = float(
        gp_mod.log_marginal_likelihood(cfg, params, jnp.asarray(X), jnp.asarray(y), 1e-10)
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-9)


def test_predict_matches_sklearn(design_and_pcs):
    X, Y_pca = design_and_pcs
    y = Y_pca[:, 1]
    ls = 0.7 * (X.max(axis=0) - X.min(axis=0))
    gpr = _sk_gpr(ls, 0.1, X, y, optimize=False)

    theta = X[:17] * 0.95 + 0.01
    ref_mean, ref_std = gpr.predict(theta, return_std=True)

    cfg = KernelConfig(nu=1.5, with_noise=True)
    params = KernelParams.create(ls, noise=0.1)
    post = gp_mod.posterior_from_params(cfg, params, jnp.asarray(X), jnp.asarray(y), 1e-10)
    mean, var = gp_mod.predict(cfg, post, jnp.asarray(theta))

    np.testing.assert_allclose(np.asarray(mean), ref_mean, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(np.sqrt(var)), ref_std, rtol=1e-6, atol=1e-9)


def test_predict_all_stacks(design_and_pcs):
    X, Y_pca = design_and_pcs
    k = 3
    ls = X.max(axis=0) - X.min(axis=0)
    cfg = KernelConfig(nu=1.5, with_noise=True)
    params = KernelParams.create(ls, noise=0.25)
    posts = jax.vmap(
        lambda y: gp_mod.posterior_from_params(cfg, params, jnp.asarray(X), y, 1e-10)
    )(jnp.asarray(Y_pca[:, :k].T))
    theta = jnp.asarray(X[:5])
    mean, var = gp_mod.predict_all(cfg, posts, theta)
    assert mean.shape == (5, k) and var.shape == (5, k)
    # cross-check one column against the single-GP path
    post0 = gp_mod.posterior_from_params(cfg, params, jnp.asarray(X), jnp.asarray(Y_pca[:, 0]), 1e-10)
    m0, v0 = gp_mod.predict(cfg, post0, theta)
    np.testing.assert_allclose(np.asarray(mean[:, 0]), np.asarray(m0), rtol=1e-12)


def test_predict_all_shared_matches_predict_all(design_and_pcs):
    """The shared-sqdiff batched predict (the sampler hot path) must agree
    with the per-PC vmapped path; per-PC length scales exercise the einsum
    contraction."""
    X, Y_pca = design_and_pcs
    k = 4
    span = X.max(axis=0) - X.min(axis=0)
    cfg = KernelConfig(nu=1.5, with_noise=True, with_constant=True)
    posts = jax.vmap(
        lambda y, s: gp_mod.posterior_from_params(
            cfg, KernelParams.create(span * s, noise=0.25 * s, constant=1.0 + s), jnp.asarray(X), y, 1e-10
        )
    )(jnp.asarray(Y_pca[:, :k].T), jnp.asarray(np.linspace(0.5, 1.5, k)))
    theta = jnp.asarray(X[:9] * 0.97 + 0.02)
    m_ref, v_ref = gp_mod.predict_all(cfg, posts, theta)
    m, v = gp_mod.predict_all_shared(cfg, posts, theta)
    np.testing.assert_allclose(np.asarray(m), np.asarray(m_ref), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=1e-10, atol=1e-13)


def test_fit_beats_or_matches_sklearn_lml(design_and_pcs):
    """Optimizer parity: our vmapped multi-restart fit must reach an LML at
    least as good as sklearn's L-BFGS-B (small tolerance for boundary optima)."""
    X, Y_pca = design_and_pcs
    # Subsample for CPU test speed
    X, y = X[:80], Y_pca[:80, 0]
    ls0 = X.max(axis=0) - X.min(axis=0)

    gpr = _sk_gpr(ls0, 0.25, X, y, optimize=True, n_restarts=3)
    ref_lml = gpr.log_marginal_likelihood_value_

    cfg = KernelConfig(nu=1.5, with_noise=True)
    spec = gp_fit.spec_from_reference_config(
        cfg,
        param_min=X.min(axis=0),
        param_max=X.max(axis=0),
        n_restarts=6,
        n_iters=80,
        alpha_jitter=1e-10,
    )
    posts = gp_fit.fit_gps(spec, jnp.asarray(X), jnp.asarray(y)[:, None], jax.random.key(0))
    ours = float(posts.lml[0])
    assert ours >= ref_lml - max(0.02 * abs(ref_lml), 0.5), (ours, ref_lml)


def test_pack_unpack_roundtrip():
    cfg = KernelConfig(nu=1.5, with_noise=True, with_constant=True)
    params = KernelParams.create(np.array([1.0, 2.0, 3.0]), noise=0.3, constant=1.7)
    flat = gp_fit.pack_params(cfg, params)
    assert flat.shape == (5,)
    back = gp_fit.unpack_params(cfg, flat, 3)
    np.testing.assert_allclose(np.asarray(back.log_length_scale), np.asarray(params.log_length_scale))
    np.testing.assert_allclose(float(back.log_noise), float(params.log_noise))
    np.testing.assert_allclose(float(back.log_constant), float(params.log_constant))


def test_lml_matmul_precision_argument_threads_through_vjp():
    """The static ``precision`` argument must change the dot precision in
    BOTH the custom_vjp forward and backward jaxprs (the fit's exploration
    stage relies on this), it must key the trace cache (trace order must not
    leak one precision into the other), and the HIGH value must stay within
    exploration-grade tolerance of the HIGHEST value."""
    from bayesian_inference_tpu.models.gp import log_marginal_likelihood_matmul
    from bayesian_inference_tpu.ops.gram import KernelConfig, KernelParams, pairwise_sqdiff

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(0, 1, (12, 3)))
    y = jnp.asarray(rng.normal(size=12))
    D2 = pairwise_sqdiff(X)
    cfg = KernelConfig(nu=1.5, with_noise=True)
    params = KernelParams.create(np.log(np.ones(3)), noise=0.3)

    def vg(p, prec):
        return jax.value_and_grad(
            lambda pp: log_marginal_likelihood_matmul(cfg, pp, D2, y, 1e-8, prec)
        )(p)

    # Trace HIGH first on purpose: a trace-cache leak would then show HIGH
    # dots in the HIGHEST jaxpr (the context-manager formulation failed
    # exactly this way).
    low = str(jax.make_jaxpr(lambda p: vg(p, jax.lax.Precision.HIGH))(params))
    plain = str(jax.make_jaxpr(lambda p: vg(p, jax.lax.Precision.HIGHEST))(params))
    n_plain_hi = plain.count("Precision.HIGHEST")
    n_low_hi = low.count("Precision.HIGHEST")
    assert n_plain_hi > 0 and n_low_hi < n_plain_hi
    assert low.count("Precision.HIGH,") > plain.count("Precision.HIGH,")
    # value parity on CPU (precision is an accelerator lowering hint; same math here)
    v_hi, _ = vg(params, jax.lax.Precision.HIGHEST)
    v_lo, _ = vg(params, jax.lax.Precision.HIGH)
    np.testing.assert_allclose(float(v_lo), float(v_hi), rtol=1e-6)


def test_multirung_halving_schedule(design_and_pcs):
    """Multi-rung successive halving (halving_schedule) must (a) prune
    degenerate rungs — keep >= pool is bit-identical to the no-halving run,
    (b) reject schedules that exhaust n_iters, and (c) reach the same best
    optimum as the single-rung schedule on a deterministic small problem
    (CPU x64: run-to-run exact)."""
    X, Y_pca = design_and_pcs
    X, y = X[:60], Y_pca[:60, :2]
    cfg = KernelConfig(nu=1.5, with_noise=True)
    spec = gp_fit.spec_from_reference_config(
        cfg, param_min=X.min(axis=0), param_max=X.max(axis=0),
        n_restarts=6, n_iters=24, alpha_jitter=1e-10,
    )
    key = jax.random.key(0)
    args = (jnp.asarray(X), jnp.asarray(y), key)

    # (a) keep >= pool prunes to nothing -> identical to halving disabled
    no_halve = gp_fit.fit_gps(spec.replace(halving_keep=0), *args)
    degenerate = gp_fit.fit_gps(spec.replace(halving_schedule=((5, 99),)), *args)
    np.testing.assert_array_equal(np.asarray(no_halve.lml), np.asarray(degenerate.lml))

    # (b) schedule spending >= n_iters is an error
    try:
        gp_fit.fit_gps(spec.replace(halving_schedule=((20, 4), (10, 2))), *args)
        assert False, "expected ValueError"
    except ValueError:
        pass

    # (c) gentle two-rung schedule matches the single-rung optimum
    single = gp_fit.fit_gps(spec.replace(halving_iters=8, halving_keep=2), *args)
    multi = gp_fit.fit_gps(
        spec.replace(halving_schedule=((4, 4), (4, 2))), *args
    )
    np.testing.assert_allclose(
        np.asarray(multi.lml), np.asarray(single.lml), rtol=0, atol=0.5
    )
