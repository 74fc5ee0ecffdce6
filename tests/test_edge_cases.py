"""Edge cases: single-bin observables through the pipeline, wide blocks in the
MVN dispatch, empty prediction filters."""

import numpy as np
import pytest
import jax.numpy as jnp

from bayesian_inference_tpu import io
from config_factory import make_analysis_yaml


def _stage_synthetic_observables(run_dir, n_design=40, n_val=6):
    """observables.h5 with a single-bin observable among normal ones."""
    rng = np.random.default_rng(0)
    labels_bins = {
        "5020__PbPb__hadron__pt_one____0-5": 1,   # single bin
        "5020__PbPb__hadron__pt_many____0-5": 7,
        "200__AuAu__hadron__pt_mid____0-10": 4,
    }
    obs = {"Data": {}, "Prediction": {}, "Prediction_validation": {}}
    for lbl, nb in labels_bins.items():
        xmin = np.arange(nb, dtype=float)
        y = rng.uniform(0.4, 1.0, nb)
        obs["Data"][lbl] = {"xmin": xmin, "xmax": xmin + 1, "y": y, "y_err": 0.05 * y}
        pred = rng.uniform(0.3, 1.1, (nb, n_design))
        pred_v = rng.uniform(0.3, 1.1, (nb, n_val))
        obs["Prediction"][lbl] = {"y": pred, "y_err": 0.05 * pred}
        obs["Prediction_validation"][lbl] = {"y": pred_v, "y_err": 0.05 * pred_v}
    obs["Design"] = rng.uniform(
        [0.1, 1, 0.01, 0.01, 0, 0.05], [0.5, 10, 10, 10, 1.5, 100], (n_design, 6)
    )
    obs["Design_validation"] = rng.uniform(
        [0.1, 1, 0.01, 0.01, 0, 0.05], [0.5, 10, 10, 10, 1.5, 100], (n_val, 6)
    )
    io.write_dict_to_h5(obs, str(run_dir), "observables.h5", verbose=False)


def test_single_bin_observable_pipeline(tmp_path):
    """Fit + likelihood + short MCMC with a 1-bin observable in the mix."""
    import jax
    from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu.mcmc.stretch import run_ensemble
    from bayesian_inference_tpu.models import emulator
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig, load_yaml
    from bayesian_inference_tpu.preprocess import preprocess
    from bayesian_inference_tpu.pipeline.configs import PreprocessingConfig

    groups = {"g": {"n_pc": 2, "observable_list": ["hadron__pt_"], "max_n_components_to_calculate": 10}}
    config_path, analysis_name, param = make_analysis_yaml(
        tmp_path, groups=groups, n_restarts=1, copy_observables=False
    )
    run_dir = tmp_path / "output" / f"{analysis_name}_{param}"
    run_dir.mkdir(parents=True)
    _stage_synthetic_observables(run_dir)

    analysis_config = load_yaml(config_path)["analyses"][analysis_name]

    # preprocessing must skip the single-bin observable gracefully
    prep_cfg = PreprocessingConfig(
        analysis_name=analysis_name, parameterization=param,
        analysis_config=analysis_config, config_file=str(config_path),
    )
    smoothed = preprocess(prep_cfg)
    assert "5020__PbPb__hadron__pt_one____0-5" in smoothed["Prediction"]

    emu_config = EmulationConfig.from_config_file(
        analysis_name=analysis_name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    emulator.fit_emulators(emu_config, n_opt_iters=10)
    results = emu_config.read_all_emulator_groups()
    exp = io.data_array_from_h5(str(run_dir), "observables.h5",
                                observable_filter=emu_config.observable_filter)
    pspec = analysis_config["parameterization"][param]
    like = build_likelihood(emu_config, results, exp,
                            theta_min=pspec["min"], theta_max=pspec["max"])
    # bucketized block padding: widths 1/7/4 all round up to one nb=8 bucket
    assert len(like.D) == 1 and like.D[0].shape == (3, 8, 8)

    x0 = np.random.default_rng(1).uniform(
        np.asarray(pspec["min"]) + 1e-3, np.asarray(pspec["max"]) - 1e-3, (8, 6)
    )
    out = run_ensemble(jax.random.key(0), like.log_posterior, jnp.asarray(x0), 20)
    assert np.all(np.isfinite(np.asarray(out["final_log_prob"])))


def test_wide_block_dispatch_matches_scipy():
    """nb > 48 routes to the XLA dense path and stays correct."""
    from scipy.linalg import cholesky, solve_triangular

    from bayesian_inference_tpu.ops.pallas_mvn import fused_block_mvn_loglike

    rng = np.random.default_rng(1)
    W, B, nb, k = 3, 2, 60, 5
    A = rng.normal(size=(B, nb, nb))
    D = A @ np.swapaxes(A, -1, -2) / nb + 2.0 * np.eye(nb)
    U = rng.normal(size=(B, nb, k)) / np.sqrt(k)
    d0 = rng.normal(size=(B, nb))
    z = rng.normal(size=(W, k))
    v = rng.uniform(0.1, 1.0, size=(W, k))
    ours = np.asarray(
        fused_block_mvn_loglike(*(jnp.asarray(a) for a in (U, D, d0, z, v)))
    )
    for w in range(W):
        ref = 0.0
        for b in range(B):
            C = D[b] + (U[b] * v[w]) @ U[b].T
            L = cholesky(C, lower=True)
            e = solve_triangular(L, d0[b] + U[b] @ z[w], lower=True)
            ref += -0.5 * e @ e - np.log(np.diag(L)).sum()
        np.testing.assert_allclose(ours[w], ref, rtol=1e-9)


def test_empty_filter_raises(test_data_dir):
    with pytest.raises(ValueError, match="No observables"):
        io.predictions_matrix_from_h5(
            str(test_data_dir), "observables.h5",
            observable_filter=io.ObservableFilter(include_list=["nonexistent"]),
        )
