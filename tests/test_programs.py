"""AOT sampler programs (mcmc/programs.py): shape-spec fidelity, operand-path
equivalence with the closure jit path, and prewarmed end-to-end runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesian_inference_tpu import io
from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
from bayesian_inference_tpu.mcmc.programs import (
    SamplerPrograms,
    chunk_sizes_for_config,
    likelihood_shape_spec,
    prewarm_sampler_programs,
)
from bayesian_inference_tpu.mcmc.stretch import run_ensemble

from tests.test_mcmc import likelihood_setup  # noqa: F401  (fixture reuse)


def _built_likelihood(likelihood_setup, mode="block"):  # noqa: F811
    emu_config, results, exp, pspec, *_ = likelihood_setup
    like = build_likelihood(
        emu_config, results, exp, theta_min=pspec["min"], theta_max=pspec["max"], mode=mode
    )
    return emu_config, like, pspec


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_shape_spec_matches_fitted_likelihood(likelihood_setup, mode):  # noqa: F811
    """The pre-fit spec must reproduce the fitted likelihood's treedef AND
    every leaf's shape/dtype — that is what guarantees a prewarmed executable
    accepts the real likelihood (both likelihood modes)."""
    emu_config, like, pspec = _built_likelihood(likelihood_setup, mode)
    spec = likelihood_shape_spec(
        emu_config, theta_min=pspec["min"], theta_max=pspec["max"], mode=mode
    )
    real_leaves, real_def = jax.tree.flatten(like)
    spec_leaves, spec_def = jax.tree.flatten(spec)
    assert real_def == spec_def
    for r, s in zip(real_leaves, spec_leaves):
        assert r.shape == s.shape and r.dtype == s.dtype


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_aot_operand_path_matches_closure_path(likelihood_setup, mode):  # noqa: F811
    """Same keys, same x0: the AOT operand-style executables must produce the
    exact chain the jit closure path produces (both likelihood modes)."""
    _, like, pspec = _built_likelihood(likelihood_setup, mode)
    ndim = len(pspec["min"])
    W = 8
    dt = like.theta_min.dtype

    key = jax.random.key(7)
    key, k0 = jax.random.split(key)
    x0 = jax.random.uniform(k0, (W, ndim), minval=like.theta_min, maxval=like.theta_max, dtype=dt)

    progs = SamplerPrograms(like, W, ndim, chunk_sizes=[25])
    progs.compile()
    assert progs.ok()

    state = progs.init(key, like, x0)
    state, ys = progs.chunk(state, like, 25)

    ref = run_ensemble(key, like.log_posterior, x0, 25)
    # Not bitwise: the closure path bakes the likelihood as HLO constants,
    # enabling constant folding the operand path can't do (last-ulp rounding).
    np.testing.assert_allclose(np.asarray(ys[0]), np.asarray(ref["chain"]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ys[1]), np.asarray(ref["log_prob"]), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(ys[2]), np.asarray(ref["acceptance_trace"]))
    np.testing.assert_allclose(np.asarray(state.coords), np.asarray(ref["coords"]), rtol=1e-10)
    # on-demand compile of a size not in the initial set
    state, ys2 = progs.chunk(state, like, 10)
    assert ys2[0].shape == (10, W, ndim)


@pytest.mark.parametrize("mode", ["block", "lowrank"])
def test_aot_programs_under_mesh_match_unsharded(likelihood_setup, mode):  # noqa: F811
    """SamplerPrograms(mesh=...) — the path a real multi-chip run takes:
    executables lowered with replicated inputs + internal walker sharding on
    the 8-device virtual mesh must reproduce the single-device jit-closure
    chain."""
    from bayesian_inference_tpu.parallel.mesh import get_mesh

    _, like, pspec = _built_likelihood(likelihood_setup, mode)
    ndim = len(pspec["min"])
    W = 32  # half-ensembles of 16 shard evenly over the 8 virtual devices
    dt = like.theta_min.dtype
    mesh = get_mesh(8)

    key = jax.random.key(3)
    key, k0 = jax.random.split(key)
    x0 = jax.random.uniform(k0, (W, ndim), minval=like.theta_min, maxval=like.theta_max, dtype=dt)

    progs = SamplerPrograms(like, W, ndim, chunk_sizes=[12], mesh=mesh)
    progs.compile()
    assert progs.ok(), progs.error
    state = progs.init(key, like, x0)
    state, ys = progs.chunk(state, like, 12)

    ref = run_ensemble(key, like.log_posterior, x0, 12)
    np.testing.assert_allclose(np.asarray(ys[0]), np.asarray(ref["chain"]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ys[1]), np.asarray(ref["log_prob"]), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(state.coords), np.asarray(ref["coords"]), rtol=1e-10)
    np.testing.assert_array_equal(np.asarray(ys[2]), np.asarray(ref["acceptance_trace"]))


def test_prewarmed_run_mcmc_matches_unwarmed(likelihood_setup):  # noqa: F811
    """run_mcmc with a prewarmed SamplerPrograms == run_mcmc compiling inline."""
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    emu_config, results, exp, pspec, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    programs = prewarm_sampler_programs(cfg)
    assert programs is not None and programs.ok()
    assert set(chunk_sizes_for_config(cfg)) <= set(programs._chunk_exe)

    out_warm = run_mcmc(cfg, seed=11, programs=programs)
    out_cold = run_mcmc(cfg, seed=11)
    np.testing.assert_array_equal(out_warm["chain"], out_cold["chain"])
    np.testing.assert_array_equal(out_warm["log_prob"], out_cold["log_prob"])
    np.testing.assert_array_equal(
        out_warm["acceptance_fraction"], out_cold["acceptance_fraction"]
    )


def test_prewarmed_lowrank_run_matches_unwarmed(likelihood_setup):  # noqa: F811
    """Lowrank mode has the same operand-style AOT path as block mode: a
    prewarmed run must reproduce the inline-compiled run exactly."""
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    *_, config_path, analysis_name, analysis_config = likelihood_setup
    analysis_config = dict(analysis_config)
    analysis_config["parameters"] = {
        **analysis_config["parameters"],
        "mcmc": {**analysis_config["parameters"]["mcmc"], "likelihood_mode": "lowrank"},
    }
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    assert cfg.likelihood_mode == "lowrank"
    programs = prewarm_sampler_programs(cfg)
    assert programs is not None and programs.ok()

    out_warm = run_mcmc(cfg, seed=5, programs=programs)
    out_cold = run_mcmc(cfg, seed=5)
    np.testing.assert_array_equal(out_warm["chain"], out_cold["chain"])
    np.testing.assert_array_equal(out_warm["log_prob"], out_cold["log_prob"])


def test_prewarm_returns_none_for_unknown_mode(likelihood_setup):  # noqa: F811
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    *_, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    assert prewarm_sampler_programs(cfg, mode="dense") is None
