"""MCMC tests: stretch-move statistical correctness on analytic targets,
likelihood parity vs the reference formula, and runner integration."""

import numpy as np
import os
import time
import pytest
import jax
import jax.numpy as jnp

from bayesian_inference_tpu import io
from bayesian_inference_tpu.mcmc import stats
from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
from bayesian_inference_tpu.mcmc.stretch import run_ensemble
from bayesian_inference_tpu.ops.mvn import mvn_loglike_dense
from conftest import make_analysis_yaml


# --------------------------------------------------------------------------------------
# Sampler statistical correctness
# --------------------------------------------------------------------------------------

def test_stretch_samples_correlated_gaussian():
    cov = np.array([[2.0, 1.2], [1.2, 1.5]])
    mu = np.array([1.0, -2.0])
    Pinv = jnp.asarray(np.linalg.inv(cov))

    def log_prob(x):
        d = x - mu
        return -0.5 * jnp.einsum("wi,ij,wj->w", d, Pinv, d)

    key = jax.random.key(1)
    x0 = jax.random.normal(key, (64, 2)) * 0.1 + mu
    out = run_ensemble(jax.random.key(2), log_prob, x0, 4000)
    samples = np.asarray(out["chain"][500:]).reshape(-1, 2)

    np.testing.assert_allclose(samples.mean(axis=0), mu, atol=0.08)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.15)
    af = np.asarray(out["acceptance_fraction"])
    assert 0.2 < af.mean() < 0.8


def test_stretch_two_seeds_agree():
    """Two independent chains sample the same distribution (KS on marginals)."""
    from scipy.stats import ks_2samp

    def log_prob(x):
        return -0.5 * jnp.sum(x**2, axis=-1)

    runs = []
    for seed in (3, 4):
        x0 = jax.random.normal(jax.random.key(seed), (32, 3)) * 0.5
        out = run_ensemble(jax.random.key(seed + 10), log_prob, x0, 3000)
        # thin to reduce autocorrelation for KS validity
        runs.append(np.asarray(out["chain"][500::20]).reshape(-1, 3))
    for d in range(3):
        assert ks_2samp(runs[0][:, d], runs[1][:, d]).pvalue > 1e-3


def test_acceptance_fraction_counts():
    def log_prob(x):
        return -0.5 * jnp.sum(x**2, axis=-1)

    x0 = jax.random.normal(jax.random.key(0), (16, 2))
    out = run_ensemble(jax.random.key(1), log_prob, x0, 100)
    af = np.asarray(out["acceptance_fraction"])
    assert af.shape == (16,)
    assert np.all(af >= 0) and np.all(af <= 1)


def test_odd_walkers_rejected():
    with pytest.raises(ValueError):
        run_ensemble(jax.random.key(0), lambda x: -jnp.sum(x**2, -1), jnp.zeros((5, 2)), 10)


# --------------------------------------------------------------------------------------
# Emulated likelihood parity vs reference formula
# --------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def likelihood_setup(tmp_path_factory):
    from bayesian_inference_tpu.models import emulator
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig, load_yaml

    tmp_path = tmp_path_factory.mktemp("mcmc_like")
    config_path, analysis_name, param = make_analysis_yaml(tmp_path)
    analysis_config = load_yaml(config_path)["analyses"][analysis_name]
    emu_config = EmulationConfig.from_config_file(
        analysis_name=analysis_name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    emulator.fit_emulators(emu_config, n_opt_iters=30)
    results = emu_config.read_all_emulator_groups()
    exp = io.data_array_from_h5(emu_config.output_dir, "observables.h5",
                                observable_filter=emu_config.observable_filter)
    pspec = analysis_config["parameterization"][param]
    return emu_config, results, exp, pspec, config_path, analysis_name, analysis_config


def test_block_likelihood_matches_reference_formula(likelihood_setup):
    """Our on-device block likelihood == host-side reference computation:
    merged emulator prediction + block-diag covariance + diag data errors +
    per-sample dense Cholesky MVN (log_posterior.py semantics)."""
    from bayesian_inference_tpu.models import emulator

    emu_config, results, exp, pspec, *_ = likelihood_setup
    like = build_likelihood(
        emu_config, results, exp, theta_min=pspec["min"], theta_max=pspec["max"], mode="block"
    )

    rng = np.random.default_rng(0)
    theta = rng.uniform(np.asarray(pspec["min"]) * 1.05 + 1e-3, np.asarray(pspec["max"]) * 0.95,
                        (7, len(pspec["min"])))

    ours = np.asarray(like.log_posterior(jnp.asarray(theta)))

    # Host reference path (per-walker semantics: truncation covariance undivided)
    pred = emulator.predict(theta, emu_config, emulation_group_results=results,
                            scale_cov_unexplained_by_n_samples=False)
    dY = pred["central_value"] - exp["y"]
    cov = pred["cov"] + np.diag(exp["y_err"] ** 2)[None, :, :]
    ref = np.asarray(mvn_loglike_dense(jnp.asarray(dY), jnp.asarray(cov)))

    np.testing.assert_allclose(ours, ref, rtol=1e-8)


def test_bounds_give_minus_inf(likelihood_setup):
    emu_config, results, exp, pspec, *_ = likelihood_setup
    like = build_likelihood(emu_config, results, exp, theta_min=pspec["min"], theta_max=pspec["max"])
    theta = np.tile(np.asarray(pspec["min"]), (2, 1)) + 0.1
    theta[1, 0] = pspec["min"][0] - 1.0  # out of bounds
    out = np.asarray(like.log_posterior(jnp.asarray(theta)))
    assert np.isfinite(out[0])
    assert out[1] == -np.inf


def test_lowrank_mode_runs_and_is_finite(likelihood_setup):
    emu_config, results, exp, pspec, *_ = likelihood_setup
    like = build_likelihood(emu_config, results, exp, theta_min=pspec["min"],
                            theta_max=pspec["max"], mode="lowrank")
    rng = np.random.default_rng(1)
    theta = rng.uniform(np.asarray(pspec["min"]) + 1e-3, np.asarray(pspec["max"]) - 1e-3,
                        (5, len(pspec["min"])))
    out = np.asarray(like.log_posterior(jnp.asarray(theta)))
    assert np.all(np.isfinite(out))


# --------------------------------------------------------------------------------------
# Runner integration
# --------------------------------------------------------------------------------------

def test_run_mcmc_end_to_end(likelihood_setup):
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    emu_config, results, exp, pspec, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out = run_mcmc(cfg, seed=0)
    assert out["chain"].shape == (cfg.n_sampling_steps, cfg.n_walkers, 6)
    assert out["log_prob"].shape == (cfg.n_sampling_steps, cfg.n_walkers)
    assert np.all(np.isfinite(out["log_prob"]))

    stored = io.read_dict_from_h5(cfg.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_allclose(stored["chain"], out["chain"])
    # all samples inside the prior box
    assert np.all(out["chain"] >= np.asarray(pspec["min"]))
    assert np.all(out["chain"] <= np.asarray(pspec["max"]))


# --------------------------------------------------------------------------------------
# Stats
# --------------------------------------------------------------------------------------

def test_credible_interval_quantile_and_hpd():
    rng = np.random.default_rng(5)
    s = rng.normal(0, 1, 200_000)
    lo, hi = stats.credible_interval(s, confidence=0.9, interval_type="quantile")
    np.testing.assert_allclose([lo, hi], [-1.645, 1.645], atol=0.02)
    lo, hi = stats.credible_interval(s, confidence=0.9, interval_type="hpd")
    np.testing.assert_allclose([lo, hi], [-1.645, 1.645], atol=0.05)


def test_map_parameters_near_median():
    rng = np.random.default_rng(6)
    s = rng.normal([1.0, -3.0], [0.5, 2.0], size=(100_000, 2))
    m = stats.map_parameters(s)
    np.testing.assert_allclose(m, [1.0, -3.0], atol=0.05)


def test_integrated_time_on_ar1():
    """AR(1) with coefficient rho has tau = (1+rho)/(1-rho)."""
    rho = 0.9
    expected = (1 + rho) / (1 - rho)  # = 19
    rng = np.random.default_rng(7)
    n, walkers = 40_000, 8
    x = np.zeros((n, walkers))
    eps = rng.normal(size=(n, walkers))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + eps[t]
    tau = stats.integrated_time(x[:, :, None])
    np.testing.assert_allclose(tau[0], expected, rtol=0.25)


def test_integrated_time_raises_on_short_chain():
    rng = np.random.default_rng(8)
    x = np.cumsum(rng.normal(size=(100, 4, 1)), axis=0)  # random walk: huge tau
    with pytest.raises(stats.AutocorrError):
        stats.integrated_time(x)


def test_logp_chain_self_consistency_under_jit():
    """Regression: stored log_prob must track coords exactly through jitted
    steps (an earlier scatter-based step assembly was miscompiled under jit,
    silently corrupting the chain)."""
    from bayesian_inference_tpu.mcmc import stretch

    def lp(x):
        a, b = x[:, 0], x[:, 1]
        return -0.5 * (a**2 / 4.0 + (b - 0.25 * a**2) ** 2)

    x0 = np.random.default_rng(0).normal(size=(16, 2))
    s = stretch.init_state(jax.random.key(0), lp, jnp.asarray(x0))
    jitted_step = jax.jit(lambda st: stretch.step(st, lp))
    for _ in range(100):
        s = jitted_step(s)
    err = np.abs(np.asarray(s.log_prob) - np.asarray(lp(s.coords))).max()
    assert err < 1e-12, err


@pytest.mark.slow
def test_checkpoint_resume(likelihood_setup, tmp_path):
    """Interrupted production resumes from the snapshot and completes the chain."""
    import pickle
    from bayesian_inference_tpu.mcmc.runner import run_mcmc, _checkpoint_path
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    emu_config, results, exp, pspec, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    # run to completion with checkpointing on
    out = run_mcmc(cfg, seed=3, checkpoint_every=16)
    assert out["chain"].shape[0] == cfg.n_sampling_steps
    assert not os.path.exists(_checkpoint_path(cfg))

    # fabricate an interrupted state: rerun, then truncate via a stored snapshot
    out_full = run_mcmc(cfg, seed=4, checkpoint_every=16)

    # simulate interruption: v3 state-only checkpoint (header + one complete
    # chunk record + a truncated tail, which resume must drop) alongside a
    # streamed chain prefix that deliberately runs PAST the snapshot (the
    # post-checkpoint slab must be trimmed on resume)
    from bayesian_inference_tpu.io import hdf5 as hdf5_mod

    record = {
        "steps_done": 16,
        "n_accepted": np.zeros(cfg.n_walkers, np.int64),
        "coords": out_full["chain"][15],
        "log_prob": out_full["log_prob"][15],
        "key_data": np.asarray(jax.random.key_data(jax.random.key(99))),
    }
    os.makedirs(cfg.mcmc_output_dir, exist_ok=True)
    os.remove(os.path.join(cfg.mcmc_output_dir, "mcmc.h5"))
    hdf5_mod.append_time_series(
        cfg.mcmc_output_dir, "mcmc.h5",
        {"chain": out_full["chain"][:24], "log_prob": out_full["log_prob"][:24]},
    )
    with open(_checkpoint_path(cfg), "wb") as f:
        pickle.dump({"version": 3, "n_total": cfg.n_sampling_steps}, f)
        pickle.dump(record, f)
        f.write(pickle.dumps({"steps_done": 32})[: 20])  # torn write
    out_resumed = run_mcmc(cfg, seed=5, checkpoint_every=16)
    assert out_resumed["chain"].shape[0] == cfg.n_sampling_steps
    np.testing.assert_allclose(out_resumed["chain"][:16], out_full["chain"][:16])
    # the streamed artifact matches the returned chain end-to-end
    stored = io.read_dict_from_h5(cfg.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_array_equal(stored["chain"], out_resumed["chain"])
    np.testing.assert_array_equal(stored["log_prob"], out_resumed["log_prob"])


def test_observables_filename_honored_end_to_end(tmp_path):
    """With observables_filename: observables_preprocessed.h5, the MCMC data
    vector, closure pseudodata source, and group slice map all read the
    preprocessed file (reference data flow: steer_analysis.py:129-131,
    jet_substructure.yaml:34; we additionally fix the reference's hardcoded
    'observables.h5' in its mcmc.py:67)."""
    from bayesian_inference_tpu.io import hdf5
    from bayesian_inference_tpu.mcmc.runner import _existing_observables_file
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig, load_yaml

    config_path, name, param = make_analysis_yaml(
        tmp_path, observables_filename="observables_preprocessed.h5"
    )
    analysis_config = load_yaml(config_path)["analyses"][name]
    cfg = MCMCConfig(
        analysis_name=name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )

    # configured file absent -> fall back to the raw ingest output
    assert _existing_observables_file(cfg) == "observables.h5"

    # stage a preprocessed copy with visibly different experimental values
    obs = hdf5.read_dict_from_h5(cfg.output_dir, "observables.h5", verbose=False)
    for label in obs["Data"]:
        obs["Data"][label]["y"] = np.asarray(obs["Data"][label]["y"]) * 1.5
    hdf5.write_dict_to_h5(obs, cfg.output_dir, "observables_preprocessed.h5", verbose=False)

    assert _existing_observables_file(cfg) == "observables_preprocessed.h5"
    d_raw = io.data_array_from_h5(cfg.output_dir, "observables.h5")
    d_pre = io.data_array_from_h5(cfg.output_dir, _existing_observables_file(cfg))
    np.testing.assert_allclose(d_pre["y"], d_raw["y"] * 1.5)

    # the slice map reads the configured file too (emulator.py GroupSliceMap)
    from bayesian_inference_tpu.models.emulator import GroupSliceMap
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig

    emu_config = EmulationConfig.from_config_file(
        analysis_name=name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    smap = GroupSliceMap.learn(emu_config)
    assert smap.n_features == d_pre["y"].shape[0]


def test_integrated_time_per_walker_matches_single_walker():
    """Per-walker tau on a 1-walker chain equals the walker-averaged estimate
    (same FFT + Sokal windowing path; reference loops emcee per walker,
    plot_mcmc.py:179-204)."""
    rng = np.random.default_rng(2)
    # AR(1) series with known autocorrelation
    n, rho = 4000, 0.9
    eps = rng.normal(size=(n, 1, 2))
    x = np.zeros((n, 1, 2))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + eps[t]
    tau_avg = stats.integrated_time(x, quiet=True)
    tau_pw, reliable = stats.integrated_time_per_walker(x)
    assert tau_pw.shape == (1, 2)
    np.testing.assert_allclose(tau_pw[0], tau_avg, rtol=1e-10)
    # theoretical tau for AR(1): (1+rho)/(1-rho) = 19
    assert 10 < tau_pw[0, 0] < 30
    assert reliable.all()


def test_acceptance_cadence_logging(caplog):
    """_log_acceptance_cadence emits the reference's cumulative-mean lines at
    exact n_logging_steps boundaries, across chunked traces with offsets."""
    import logging as _logging
    import types

    from bayesian_inference_tpu.mcmc.runner import _log_acceptance_cadence

    cfg = types.SimpleNamespace(n_logging_steps=10, n_sampling_steps=50)
    trace = np.linspace(0.1, 0.5, 50)

    with caplog.at_level(_logging.INFO, logger="bayesian_inference_tpu.mcmc.runner"):
        _log_acceptance_cadence(cfg, trace)
    msgs = [r.message for r in caplog.records]
    assert len(msgs) == 5
    for j, m in enumerate(msgs):
        step = 10 * (j + 1)
        assert m.startswith(f"MCMC step {step}/50:")
        expect = trace[:step].mean()
        assert f"{expect:.3f}" in m

    # chunked dispatch: same lines from two chunks with offset/prior_sum
    caplog.clear()
    with caplog.at_level(_logging.INFO, logger="bayesian_inference_tpu.mcmc.runner"):
        _log_acceptance_cadence(cfg, trace[:23])
        _log_acceptance_cadence(cfg, trace[23:], offset=23, prior_sum=float(trace[:23].sum()))
    msgs2 = [r.message for r in caplog.records]
    assert msgs2 == msgs


def test_production_chunk_honors_logging_cadence():
    """Short runs chunk at (a divisor rounding of) n_logging_steps so the
    cadence lines appear during sampling, not post-hoc;
    long runs keep eighth dispatches; no cadence -> single dispatch."""
    import types

    from bayesian_inference_tpu.mcmc.runner import _production_chunk

    def cfg(n, log):
        return types.SimpleNamespace(n_sampling_steps=n, n_logging_steps=log)

    assert _production_chunk(cfg(50000, 1000), None) == 6250    # eighth dispatch
    assert _production_chunk(cfg(20004, 0), None) == 5001       # 4-divisible only
    assert _production_chunk(cfg(5000, 1000), None) == 1000     # exact divisor
    assert _production_chunk(cfg(5000, 900), None) == 1000      # rounded to divisor
    assert _production_chunk(cfg(5000, 0), None) is None        # no cadence
    assert _production_chunk(cfg(5000, 6000), None) is None     # cadence > run
    assert _production_chunk(cfg(5000, 1000), 250) == 250       # checkpoint wins


def test_production_sizes_ramp_and_uniform(monkeypatch):
    """Long default runs get the ramped chunk sequence (first slab downloads
    after ~3% of the scan; the LAST chunk is split in two so the only
    non-overlapped download carries half the bytes); explicit cadences stay
    uniform (checkpoint boundary alignment => bit-exact resume); ramp sizes
    sum to the run and use only 2-3 distinct program shapes."""
    import types

    from bayesian_inference_tpu.mcmc.runner import _production_sizes

    def cfg(n, log):
        return types.SimpleNamespace(n_sampling_steps=n, n_logging_steps=log)

    ramp = _production_sizes(cfg(50000, 1000), None)  # 16 | n, 32 does not
    assert ramp == [3125, 3125] + [6250] * 6 + [3125, 3125]
    assert sum(ramp) == 50000 and len(set(ramp)) == 2
    ramp32 = _production_sizes(cfg(64000, 0), None)   # 32 | n: finer lead-in
    assert ramp32 == [2000, 2000, 4000] + [8000] * 6 + [4000, 4000]
    assert sum(ramp32) == 64000 and len(set(ramp32)) == 3
    # explicit checkpoint cadence: uniform
    assert _production_sizes(cfg(50000, 1000), 12500) == [12500] * 4
    # BIQ_DISPATCH_CHUNK override: uniform at the override
    monkeypatch.setenv("BIQ_DISPATCH_CHUNK", "25000")
    assert _production_sizes(cfg(50000, 1000), None) == [25000, 25000]
    monkeypatch.delenv("BIQ_DISPATCH_CHUNK")
    # non-32-divisible long run: uniform eighths/quarters fallback
    assert _production_sizes(cfg(20004, 0), None) == [5001] * 4
    # short run: logging-cadence chunking; no cadence -> single dispatch
    assert _production_sizes(cfg(5000, 1000), None) == [1000] * 5
    assert _production_sizes(cfg(5000, 0), None) is None


def test_run_mcmc_lowrank_mode(likelihood_setup):
    """Full runner in 'lowrank' likelihood mode (Woodbury path): no operand
    AOT programs exist for it, so this exercises the jit-closure fallback."""
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    *_, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out = run_mcmc(cfg, seed=5, mode="lowrank")
    assert out["chain"].shape[0] == cfg.n_sampling_steps
    assert np.isfinite(out["log_prob"]).all()
    assert 0.0 < np.mean(out["acceptance_fraction"]) < 1.0


def test_split_rhat():
    """Converged chains give R-hat ~ 1; walkers stuck in different modes do not."""
    rng = np.random.default_rng(0)
    n_t, n_w = 4000, 16
    # stationary AR(1), all walkers sampling the same distribution
    x = rng.standard_normal((n_t, n_w, 2))
    for t in range(1, n_t):
        x[t] = 0.6 * x[t - 1] + np.sqrt(1 - 0.36) * x[t]
    r = stats.split_rhat(x)
    assert r.shape == (2,)
    assert np.all(r < 1.02), r

    # non-converged: half the walkers offset by a large constant
    y = x.copy()
    y[:, : n_w // 2, 0] += 10.0
    r_bad = stats.split_rhat(y)
    assert r_bad[0] > 1.5, r_bad
    assert r_bad[1] < 1.02


def test_runner_reports_split_rhat(likelihood_setup):
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    *_, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out = run_mcmc(cfg, seed=8)
    assert out["split_rhat"].shape == (6,)
    assert np.all(np.isfinite(out["split_rhat"]))
    stored = io.read_dict_from_h5(cfg.mcmc_output_dir, "mcmc.h5", verbose=False)
    np.testing.assert_allclose(stored["split_rhat"], out["split_rhat"])


def test_integrated_time_batched_matches_per_point():
    """The one-FFT-pass batched estimator equals per-point integrated_time,
    including the reliability (chain >= 50 tau) verdict."""
    from bayesian_inference_tpu.mcmc import stats

    rng = np.random.default_rng(5)
    n, P, W, D = 3000, 3, 4, 2
    rho = np.array([0.3, 0.9])
    chains = np.zeros((n, P, W, D))
    eps = rng.normal(size=(n, P, W, D))
    for t in range(1, n):
        chains[t] = rho * chains[t - 1] + eps[t]
    tau_b, reliable_b = stats.integrated_time_batched(chains)
    assert tau_b.shape == (P, D) and reliable_b.shape == (P, D)
    for p in range(P):
        tau_p = stats.integrated_time(chains[:, p], quiet=True)
        np.testing.assert_allclose(tau_b[p], tau_p, rtol=1e-12)
        assert reliable_b[p].all() == (not np.any(50.0 * tau_p > n))


def test_truncated_lag_acf_matches_full_length(monkeypatch):
    """The lag-capped ACF path (engaged on long chains) returns bit-identical
    taus to the full-length transform when the Sokal window converges within
    the cap, and falls back to the exact full-length result when it does not."""
    from bayesian_inference_tpu.mcmc import stats

    rng = np.random.default_rng(11)
    n, W, D = 2000, 6, 2
    chain = np.zeros((n, W, D))
    eps = rng.normal(size=(n, W, D))
    for t in range(1, n):
        chain[t] = np.array([0.5, 0.9]) * chain[t - 1] + eps[t]

    monkeypatch.setenv("BIQ_ACF_MAX_LAG", "0")
    tau_full = stats.integrated_time(chain, quiet=True)
    tau_pw_full, rel_full = stats.integrated_time_per_walker(chain)
    tau_b_full, relb_full = stats.integrated_time_batched(chain[:, None])

    # cap 256 >> window (~5*tau, tau ~ 2-20): truncated path picks the same
    # window; tau values agree to FFT rounding (different transform lengths)
    monkeypatch.setenv("BIQ_ACF_MAX_LAG", "256")
    np.testing.assert_allclose(
        stats.integrated_time(chain, quiet=True), tau_full, rtol=1e-8
    )
    tau_pw, rel = stats.integrated_time_per_walker(chain)
    np.testing.assert_allclose(tau_pw, tau_pw_full, rtol=1e-8)
    np.testing.assert_array_equal(rel, rel_full)
    tau_b, relb = stats.integrated_time_batched(chain[:, None])
    np.testing.assert_allclose(tau_b, tau_b_full, rtol=1e-8)
    np.testing.assert_array_equal(relb, relb_full)

    # pathological chain (random walk: window far beyond a tiny cap) must
    # fall back to the exact full-length estimate in every variant
    walk = np.cumsum(rng.normal(size=(n, W, D)), axis=0)
    monkeypatch.setenv("BIQ_ACF_MAX_LAG", "0")
    walk_full = stats.integrated_time(walk, quiet=True)
    walk_pw_full, _ = stats.integrated_time_per_walker(walk)
    walk_b_full, _ = stats.integrated_time_batched(walk[:, None])
    monkeypatch.setenv("BIQ_ACF_MAX_LAG", "64")
    np.testing.assert_array_equal(stats.integrated_time(walk, quiet=True), walk_full)
    np.testing.assert_array_equal(stats.integrated_time_per_walker(walk)[0], walk_pw_full)
    np.testing.assert_array_equal(stats.integrated_time_batched(walk[:, None])[0], walk_b_full)


def test_bucket_layout_cost_model():
    """The DP bucket partition minimizes launches + padded work at the
    kernel's power-of-two width (see likelihood._LAUNCH_COST): realistic width
    spreads keep fine buckets (launches are near-free inside the scan body),
    single-block widths merge into a neighbor when padding is cheaper than a
    launch, and the layout is a stable pure function of the widths."""
    from bayesian_inference_tpu.mcmc.likelihood import bucket_layout

    # fixture-like spread (padded 8/16/24): fine buckets survive, except where
    # merging is cheaper than a launch
    layout = bucket_layout([7] * 6 + [15] * 6 + [21] * 4)
    assert [nb for nb, _ in layout] == sorted(nb for nb, _ in layout)
    # every index appears exactly once across buckets
    assert sorted(i for _, ix in layout for i in ix) == list(range(16))
    # a single narrow outlier merges up into the wide bucket (padding one
    # block 8->16 is cheaper than a whole launch); the converse — padding 64
    # narrow blocks up to absorb one wide one — costs more than a launch, so
    # the wide block gets its own
    layout = bucket_layout([15] * 64 + [7])
    assert [(nb, len(ix)) for nb, ix in layout] == [(16, 65)]
    layout = bucket_layout([7] * 64 + [15])
    assert [(nb, len(ix)) for nb, ix in layout] == [(8, 64), (16, 1)]

    # pathological outlier: one 45-wide block among a hundred 7-wide must NOT
    # drag everything to nb=48
    layout = bucket_layout([7] * 100 + [45])
    assert [(nb, len(ix)) for nb, ix in layout] == [(8, 100), (48, 1)]

    # launch_cost=0 degenerates to exact per-width buckets
    layout = bucket_layout([7, 15, 21, 7], launch_cost=0.0)
    assert [(nb, sorted(ix)) for nb, ix in layout] == [(8, [0, 3]), (16, [1]), (24, [2])]

    # widths below 8 still pad up to the 8-sublane minimum
    assert bucket_layout([1, 2, 3]) == [(8, [0, 1, 2])]


def test_device_acf_stats_match_host(monkeypatch):
    """device_mean_power / device_split_rhat (accelerator-offloaded spectrum
    and R-hat, used by the runner on an accelerator) reproduce the host estimators. On
    the CPU test backend the device path runs through XLA:CPU — same math,
    different FFT implementation — so parity is to FFT rounding."""
    from bayesian_inference_tpu.mcmc import stats

    rng = np.random.default_rng(5)
    n, W, D = 1500, 8, 3
    chain = np.zeros((n, W, D))
    eps = rng.normal(size=(n, W, D))
    for t in range(1, n):
        chain[t] = np.array([0.3, 0.7, 0.9]) * chain[t - 1] + eps[t]
    chain = chain.astype(np.float64)

    monkeypatch.setenv("BIQ_ACF_MAX_LAG", "0")  # host baseline: full length
    tau_host = stats.integrated_time(chain, quiet=True)

    power, nfft = stats.device_mean_power(chain)
    assert nfft == 2 * stats._next_pow_two(n)
    tau_dev = stats.integrated_time(chain, quiet=True, mean_power=(power, nfft))
    np.testing.assert_allclose(tau_dev, tau_host, rtol=1e-8)

    # pieces-list input (resumed prefix + device slabs) concatenates on device
    power2, nfft2 = stats.device_mean_power([chain[:700], chain[700:]])
    np.testing.assert_allclose(power2, power, rtol=1e-9)
    assert nfft2 == nfft

    rhat_host = stats.split_rhat(chain)
    rhat_dev = stats.device_split_rhat([chain[:700], chain[700:]])
    np.testing.assert_allclose(rhat_dev, rhat_host, rtol=1e-10)

    # tau-vs-length from the stored spectrum (plot-stage offload): final
    # point == the full-chain estimate exactly; earlier points finite,
    # positive, and within the exact prefix estimator's noise band.
    lengths = np.unique(np.logspace(2, np.log10(n), 6).astype(int))
    curve = stats.tau_vs_length_from_power(power, nfft, n, lengths)
    assert curve.shape == (len(lengths), D)
    np.testing.assert_allclose(curve[-1], tau_host, rtol=1e-8)
    exact = np.array([stats.integrated_time(chain[:m], quiet=True) for m in lengths])
    assert np.all(curve > 0)
    # same convergence story as the exact curve: agree where both have
    # converged (the last few lengths), loose everywhere (estimator noise)
    np.testing.assert_allclose(curve[-2:], exact[-2:], rtol=0.35)


def test_device_closure_stats_match_host():
    """device_closure_stats (one scanned on-device program over closure
    points) reproduces per-point host tau and split_rhat."""
    from bayesian_inference_tpu.mcmc import stats

    rng = np.random.default_rng(9)
    n, P, W, D = 600, 3, 4, 2
    chain = np.zeros((n, P, W, D))
    eps = rng.normal(size=(n, P, W, D))
    coef = np.array([0.2, 0.8])
    for t in range(1, n):
        chain[t] = coef * chain[t - 1] + eps[t]

    # two slabs exercise the on-device concat
    powers, nfft, rhats = stats.device_closure_stats([chain[:250], chain[250:]])
    assert powers.shape == (P, nfft // 2 + 1, D) and rhats.shape == (P, D)
    for p in range(P):
        tau_dev, rel_dev = stats.integrated_time_from_power(
            powers[p], nfft, n, out_dtype=chain.dtype
        )
        tau_host = stats.integrated_time(chain[:, p], quiet=True)
        np.testing.assert_allclose(tau_dev, tau_host, rtol=1e-8)
        np.testing.assert_allclose(
            rhats[p], stats.split_rhat(chain[:, p]), rtol=1e-10
        )


def test_hedged_fetcher_races_stalled_transfer():
    """A primary transfer that never completes is rescued by the hedge's
    second independent transfer of the same buffer."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from bayesian_inference_tpu.mcmc.runner import _HedgedFetcher

    buf = np.arange(12.0).reshape(3, 4)
    never = threading.Event()
    pool = ThreadPoolExecutor(max_workers=1)
    stalled = pool.submit(never.wait, 60.0)  # simulated stalled RPC
    hedge = _HedgedFetcher(hedge_s=0.05)
    out = hedge.result(stalled, buf, "test buffer")
    np.testing.assert_array_equal(out, buf)
    never.set()
    pool.shutdown()
    hedge.shutdown()

    # fast path: a completed future returns without hedging
    done = ThreadPoolExecutor(max_workers=1).submit(np.asarray, buf)
    hedge2 = _HedgedFetcher(hedge_s=10.0)
    np.testing.assert_array_equal(hedge2.result(done, buf, "fast"), buf)
    assert hedge2._pool is None  # hedge never fired
    hedge2.shutdown()


def test_chunked_production_with_forced_hedging(likelihood_setup, monkeypatch):
    """Force the hedge on EVERY chunk fetch (deadline ~0) through the real
    chunked production path: results must equal an unhedged run bit-exactly
    (both transfers carry the same buffer)."""
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    emu_config, results, exp, pspec, config_path, analysis_name, analysis_config = likelihood_setup
    cfg = MCMCConfig(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out_plain = run_mcmc(cfg, seed=7, checkpoint_every=16)
    monkeypatch.setenv("BIQ_FETCH_HEDGE_S", "0.001")
    out_hedged = run_mcmc(cfg, seed=7, checkpoint_every=16)
    np.testing.assert_array_equal(out_hedged["chain"], out_plain["chain"])
    np.testing.assert_array_equal(out_hedged["log_prob"], out_plain["log_prob"])


def test_hedged_fetcher_survives_failed_primary():
    """A primary that ERRORS (a failed transfer) must not sink the fetch:
    before the hedge fires it triggers a one-shot retry; after the hedge
    fires, a failed racer is dropped while the healthy one is still in
    flight (the whole point of the hedge)."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor
    from bayesian_inference_tpu.mcmc.runner import _HedgedFetcher

    data = np.arange(6.0).reshape(2, 3)

    class SlowBuf:
        """np.asarray(self) takes ~0.3 s — keeps the hedge in flight while
        the primary fails."""
        def __array__(self, dtype=None, copy=None):
            time.sleep(0.3)
            return data if dtype is None else data.astype(dtype)

    pool = ThreadPoolExecutor(max_workers=2)

    # 1) primary fails FAST (before the hedge deadline): retried once
    def _boom():
        raise OSError("simulated transfer failure")

    hedge = _HedgedFetcher(hedge_s=5.0)
    out = hedge.result(pool.submit(_boom), data, "fast-fail")
    np.testing.assert_array_equal(out, data)
    hedge.shutdown()

    # 2) primary stalls past the deadline, THEN fails while the hedge
    #    transfer is still healthy and in flight: the hedge's result wins
    fail_now = threading.Event()

    def _stall_then_boom():
        fail_now.wait(30.0)
        raise OSError("simulated stalled-then-broken RPC")

    hedge = _HedgedFetcher(hedge_s=0.05)
    primary = pool.submit(_stall_then_boom)
    t = threading.Timer(0.1, fail_now.set)  # fail after hedge fires
    t.start()
    out = hedge.result(primary, SlowBuf(), "stall-then-fail")
    np.testing.assert_array_equal(out, data)
    t.join()
    hedge.shutdown()

    # 3) every transfer fails: the error is raised, not swallowed
    hedge = _HedgedFetcher(hedge_s=0.05)
    with pytest.raises(OSError, match="simulated"):
        hedge.result(pool.submit(_boom), _FailingBuf(), "all-fail")
    hedge.shutdown()
    pool.shutdown(wait=False)


class _FailingBuf:
    def __array__(self, dtype=None, copy=None):
        raise OSError("simulated hedge failure")


def test_hedged_fetcher_adaptive_deadline():
    """Size-aware hedging: once a link rate is observed, the deadline for a
    transfer is FACTOR x expected_time clamped to [min_s, hedge_s]; with no
    rate (or no size) it stays at the flat cap. A stall on a small transfer
    under a learned-fast link hedges at the floor, not the 45 s cap."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from bayesian_inference_tpu.mcmc.runner import _HedgedFetcher, _nbytes

    hedge = _HedgedFetcher(hedge_s=45.0)
    hedge.min_s, hedge.factor = 5.0, 4.0
    # no rate learned yet -> flat cap, regardless of size
    assert hedge.deadline_for(10**9) == 45.0
    assert hedge.deadline_for(None) == 45.0
    # learn ~10 MB/s
    hedge.observe(10_000_000, 1.0)
    # 1 MB expected 0.1s -> 4*0.1+1 = 1.4 -> clamped up to the 5 s floor
    assert hedge.deadline_for(1_000_000) == 5.0
    # 100 MB expected 10s -> 41 s, inside [5, 45]
    assert abs(hedge.deadline_for(100_000_000) - 41.0) < 1e-9
    # 1 GB expected 100s -> clamped to the 45 s cap
    assert hedge.deadline_for(10**9) == 45.0
    # EWMA halves toward a new measurement
    hedge.observe(30_000_000, 1.0)  # 30 MB/s sample -> ewma 20 MB/s
    assert abs(hedge._rate_Bps - 20e6) < 1e-3
    # degenerate samples are ignored
    hedge.observe(0, 1.0)
    hedge.observe(100, 0.0)
    assert abs(hedge._rate_Bps - 20e6) < 1e-3
    hedge.shutdown()

    # end-to-end: a stalled small transfer under a learned rate is rescued
    # at ~min_s, not the flat cap (use tiny floors to keep the test fast)
    buf = np.arange(8.0)
    never = threading.Event()
    pool = ThreadPoolExecutor(max_workers=1)
    hedge = _HedgedFetcher(hedge_s=60.0)
    hedge.min_s, hedge.factor = 0.05, 4.0
    hedge.observe(10_000_000, 1.0)  # fast link
    stalled = pool.submit(never.wait, 30.0)
    t0 = time.perf_counter()
    out = hedge.result(stalled, buf, "adaptive", nbytes=buf.nbytes)
    assert time.perf_counter() - t0 < 10.0  # rescued well under hedge_s
    np.testing.assert_array_equal(out, buf)
    assert hedge.fired == 1
    never.set()
    pool.shutdown()
    hedge.shutdown()

    # _nbytes: arrays and tuples of arrays (the quantized log-prob triple)
    a = np.zeros((4, 3), np.uint16)
    assert _nbytes(a) == 24
    assert _nbytes((a, np.float32(0.0), np.float32(1.0))) == 24 + 4 + 4
    assert _nbytes(object()) == 0


def test_hedged_fetcher_deadline_on_double_hang():
    """If the primary AND the hedged transfer both hang (the device connection
    is gone, not one stalled transfer), the fetcher must raise within its
    escalation deadline with a resume hint — not loop on 'transfers still
    pending' forever."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor
    from bayesian_inference_tpu.mcmc.runner import _HedgedFetcher

    release = threading.Event()

    class HungBuf:
        def __array__(self, dtype=None, copy=None):
            release.wait(60.0)  # simulated second hung RPC
            return np.zeros(2)

    pool = ThreadPoolExecutor(max_workers=1)
    primary = pool.submit(release.wait, 60.0)  # simulated first hung RPC
    hedge = _HedgedFetcher(hedge_s=0.05, deadline_s=0.4)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="resume"):
        hedge.result(primary, HungBuf(), "double-hang")
    assert time.monotonic() - t0 < 10.0  # escalated, did not spin forever
    release.set()
    hedge.shutdown()
    pool.shutdown(wait=False)


def test_chain_quantizer_roundtrip_error_bound():
    """uint16 prior-box quantization round-trips every in-box coordinate to
    within range/131070 (half a quantization step), hits the box corners
    exactly, and preserves dtype/shape."""
    from bayesian_inference_tpu.mcmc.runner import _ChainQuantizer

    rng = np.random.default_rng(3)
    tmin = np.array([-2.0, 0.5, 10.0])
    tmax = np.array([3.0, 0.75, 1000.0])
    q = _ChainQuantizer(tmin, tmax, np.dtype(np.float64))
    x = tmin + (tmax - tmin) * rng.random((64, 7, 3))
    x[0, 0] = tmin  # exact corners
    x[0, 1] = tmax
    out = q.dequantize(np.asarray(q.quantize(jnp.asarray(x))))
    assert out.shape == x.shape and out.dtype == x.dtype
    bound = (tmax - tmin) / 131070.0
    assert np.all(np.abs(out - x) <= bound * (1 + 1e-12))
    np.testing.assert_array_equal(out[0, 0], tmin)
    np.testing.assert_array_equal(out[0, 1], tmax)


def test_logp_minmax_quantizer_roundtrip_and_sentinel():
    """Per-chunk min/span uint16 log-prob quantization: absolute error
    <= span/131068 on finite values, -inf round-trips through the sentinel
    code, and the degenerate all-equal slab decodes exactly."""
    from bayesian_inference_tpu.mcmc.runner import _ChainQuantizer

    q = _ChainQuantizer(np.zeros(2), np.ones(2), np.dtype(np.float64))
    rng = np.random.default_rng(5)
    lp = rng.uniform(-130.0, -40.0, (64, 7))
    lp[3, 2] = -np.inf
    out = q.dequantize_logp(q.quantize_logp(jnp.asarray(lp)))
    assert out.shape == lp.shape and out.dtype == lp.dtype
    assert out[3, 2] == -np.inf
    finite = np.isfinite(lp)
    span = lp[finite].max() - lp[finite].min()
    assert np.all(np.abs(out[finite] - lp[finite]) <= span / 131068.0 * (1 + 1e-12))
    # degenerate slab: every finite value identical
    flat = np.full((4, 3), -7.25)
    out2 = q.dequantize_logp(q.quantize_logp(jnp.asarray(flat)))
    np.testing.assert_array_equal(out2, flat)


def test_production_uint16_chain_transfer_parity(likelihood_setup, monkeypatch):
    """End-to-end run with chain_transfer=uint16: sampling is UNCHANGED (the
    quantization only rides the download), so acceptance is bit-identical to a
    lossless run, the archived chain differs by at most half a prior-box
    quantization step per coordinate, and the archived log-prob by at most
    half a per-chunk min/span step."""
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.pipeline.configs import MCMCConfig

    emu_config, results, exp, pspec, config_path, analysis_name, analysis_config = likelihood_setup
    kw = dict(
        analysis_name=analysis_name, parameterization="exponential",
        analysis_config=analysis_config, config_file=str(config_path),
    )
    out_plain = run_mcmc(MCMCConfig(**kw), seed=11, checkpoint_every=16)
    monkeypatch.setenv("BIQ_CHAIN_TRANSFER", "uint16")
    cfg_q = MCMCConfig(**kw)
    assert cfg_q.chain_transfer == "uint16"
    out_q = run_mcmc(cfg_q, seed=11, checkpoint_every=16)
    np.testing.assert_array_equal(
        out_q["acceptance_fraction"], out_plain["acceptance_fraction"]
    )
    tmin = np.asarray(pspec["min"], float)
    tmax = np.asarray(pspec["max"], float)
    bound = (tmax - tmin) / 131070.0
    err = np.abs(out_q["chain"] - out_plain["chain"])
    assert err.max() > 0  # quantization actually happened
    assert np.all(err <= bound * (1 + 1e-12))
    # archived log-prob: bounded by each checkpoint chunk's own finite span
    lp_p, lp_q = out_plain["log_prob"], out_q["log_prob"]
    assert lp_q.shape == lp_p.shape
    for s0 in range(0, lp_p.shape[0], 16):
        sl = slice(s0, s0 + 16)
        fin = np.isfinite(lp_p[sl])
        np.testing.assert_array_equal(np.isfinite(lp_q[sl]), fin)
        span = lp_p[sl][fin].max() - lp_p[sl][fin].min()
        assert np.all(
            np.abs(lp_q[sl][fin] - lp_p[sl][fin]) <= span / 131068.0 * (1 + 1e-12)
        )
