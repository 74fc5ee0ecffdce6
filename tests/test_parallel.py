"""Multi-chip sharding tests on the 8-device virtual CPU mesh: sharded GP fit
and walker-sharded MCMC must produce the same results as single-device runs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from bayesian_inference_tpu.models import gp_fit
from bayesian_inference_tpu.mcmc.stretch import run_ensemble
from bayesian_inference_tpu.ops.gram import KernelConfig
from bayesian_inference_tpu.parallel.mesh import get_mesh, make_sharded_log_prob, shard_leading_axis


def test_mesh_has_8_devices():
    mesh = get_mesh()
    assert mesh.devices.size == 8


@pytest.mark.parametrize("lml_impl", ["autodiff", "matmul"])
def test_sharded_gp_fit_matches_unsharded(lml_impl):
    rng = np.random.default_rng(0)
    N, d, k = 24, 3, 2
    X = jnp.asarray(rng.uniform(0, 1, (N, d)))
    Y = jnp.asarray(rng.normal(size=(N, k)))
    spec = gp_fit.spec_from_reference_config(
        KernelConfig(nu=1.5, with_noise=True),
        param_min=np.zeros(d), param_max=np.ones(d),
        n_restarts=7, n_iters=10, alpha_jitter=1e-8,  # k*R = 16 instances over 8 devices
        lml_impl=lml_impl,  # matmul: the blocked factorization under a mesh
    )
    posts_single = gp_fit.fit_gps(spec, X, Y, jax.random.key(0), mesh=None)
    posts_mesh = gp_fit.fit_gps(spec, X, Y, jax.random.key(0), mesh=get_mesh())
    np.testing.assert_allclose(
        np.asarray(posts_single.lml), np.asarray(posts_mesh.lml), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(posts_single.params.log_length_scale),
        np.asarray(posts_mesh.params.log_length_scale), rtol=1e-8,
    )


def test_walker_sharded_mcmc_matches_unsharded():
    def log_prob(x):
        return -0.5 * jnp.sum(x**2, axis=-1)

    mesh = get_mesh()
    sharded_lp = make_sharded_log_prob(log_prob, mesh)
    x0 = jax.random.normal(jax.random.key(0), (32, 3))

    out_plain = run_ensemble(jax.random.key(1), log_prob, x0, 50)
    out_shard = run_ensemble(jax.random.key(1), sharded_lp, x0, 50)
    np.testing.assert_allclose(
        np.asarray(out_plain["chain"]), np.asarray(out_shard["chain"]), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(out_plain["acceptance_fraction"]),
        np.asarray(out_shard["acceptance_fraction"]),
    )


def test_shard_leading_axis_none_mesh_is_noop():
    x = jnp.ones((4, 3))
    assert shard_leading_axis(x, None) is x


@pytest.mark.slow
def test_run_mcmc_with_mesh(tmp_path):
    """Full runner with the walker batch sharded over the 8-device mesh."""
    import yaml
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.models import emulator
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig, MCMCConfig, load_yaml
    from conftest import make_analysis_yaml

    groups = {"default_group": {"n_pc": 2, "observable_list": ["hadron__pt_"]}}
    config_path, analysis_name, param = make_analysis_yaml(
        tmp_path, groups=groups, n_walkers=16, n_burn_steps=8, n_sampling_steps=24, n_restarts=1
    )
    analysis_config = load_yaml(config_path)["analyses"][analysis_name]
    emu_config = EmulationConfig.from_config_file(
        analysis_name=analysis_name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    emulator.fit_emulators(emu_config, n_opt_iters=10)
    cfg = MCMCConfig(analysis_name=analysis_name, parameterization=param,
                     analysis_config=analysis_config, config_file=str(config_path))
    out_mesh = run_mcmc(cfg, seed=0, mesh=get_mesh())
    out_single = run_mcmc(cfg, seed=0, mesh=None)
    np.testing.assert_allclose(out_mesh["chain"], out_single["chain"], rtol=1e-10)
    # both paths must run the value-independent AOT executables (the mesh run
    # used to silently fall back to inline jit, losing the persistent-cache
    # keys mcmc/programs.py exists to provide)
    assert out_mesh["used_aot_programs"] and out_single["used_aot_programs"]

    # warm == cold: a prewarmed mesh-sharded program handle reproduces the
    # inline-compiled mesh run exactly
    from bayesian_inference_tpu.mcmc.programs import prewarm_sampler_programs

    programs = prewarm_sampler_programs(cfg, mesh=get_mesh())
    out_warm = run_mcmc(cfg, seed=0, mesh=get_mesh(), programs=programs)
    np.testing.assert_allclose(out_warm["chain"], out_mesh["chain"], rtol=0, atol=0)
