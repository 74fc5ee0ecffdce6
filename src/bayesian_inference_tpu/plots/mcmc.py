"""MCMC diagnostics plots (reference plot_mcmc.py): acceptance fraction,
log-posterior traces/heatmap, integrated autocorrelation time, posterior
pairplot, design-vs-posterior observables."""

from __future__ import annotations

import logging
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from bayesian_inference_tpu.io import hdf5
from bayesian_inference_tpu.mcmc import stats
from bayesian_inference_tpu.plots.utils import ensure_plot_dir

logger = logging.getLogger(__name__)


def plot(config) -> None:
    mcmc_h5 = os.path.join(config.mcmc_output_dir, "mcmc.h5")
    if not os.path.exists(mcmc_h5):
        logger.info(f"No mcmc.h5 found at {mcmc_h5}; skipping MCMC plots")
        return
    results = hdf5.read_dict_from_h5(config.mcmc_output_dir, "mcmc.h5", verbose=False)
    plot_dir = ensure_plot_dir(config.output_dir, "plot_mcmc")

    chain = np.asarray(results["chain"])  # (steps, walkers, ndim)
    log_prob = np.asarray(results["log_prob"])
    names = config.analysis_config["parameterization"][config.parameterization]["names"]

    _plot_acceptance(np.asarray(results["acceptance_fraction"]), plot_dir)
    _plot_log_posterior(log_prob, plot_dir)
    # mean_power: walker-averaged ACF spectrum the runner computed on-device
    # (absent on CPU runs / old artifacts -> exact host fallback inside)
    mp, mp_nfft = results.get("mean_power"), results.get("mean_power_nfft")
    mean_power = (np.asarray(mp), int(np.asarray(mp_nfft))) if mp is not None and mp_nfft is not None else None
    _plot_autocorrelation(chain, plot_dir, mean_power=mean_power)
    sampler_tau = results.get("autocorrelation_time")
    _plot_autocorrelation_per_walker(chain, log_prob, names, plot_dir, sampler_tau=sampler_tau)
    _plot_pairplot(chain, names, plot_dir, confidence=getattr(config, "confidence", None))
    _plot_traces(chain, names, plot_dir)
    try:
        _plot_posterior_observables(chain, config, plot_dir)
    except FileNotFoundError as e:
        logger.info(f"Skipping posterior-observable plots (missing artifacts): {e}")


def _plot_acceptance(af: np.ndarray, plot_dir: str) -> None:
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(af, "o", ms=3)
    ax.axhline(af.mean(), color="r", ls="--", label=f"mean = {af.mean():.3f}")
    ax.set_xlabel("walker")
    ax.set_ylabel("acceptance fraction")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "acceptance_fraction.pdf"))
    plt.close(fig)


def _plot_log_posterior(log_prob: np.ndarray, plot_dir: str) -> None:
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for w in range(0, log_prob.shape[1], max(1, log_prob.shape[1] // 20)):
        ax1.plot(log_prob[:, w], lw=0.3, alpha=0.5)
    ax1.set_xlabel("step")
    ax1.set_ylabel("log posterior")
    finite = log_prob[np.isfinite(log_prob)]
    if finite.size:
        ax2.hist(finite.ravel(), bins=100)
    ax2.set_xlabel("log posterior")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "log_posterior.pdf"))
    plt.close(fig)


def _plot_autocorrelation(chain: np.ndarray, plot_dir: str, mean_power=None) -> None:
    """tau estimates vs chain length (emcee-style convergence check).

    With ``mean_power`` (the runner's on-device ACF spectrum, (power, nfft)),
    the curve comes from ONE host inverse transform instead of ~8 full
    forward-FFT passes over every walker series of a production 50k x 100
    chain. Exact
    per-prefix fallback when the artifact predates the spectrum."""
    n_steps = chain.shape[0]
    lengths = np.unique(np.logspace(2, np.log10(n_steps), 8).astype(int))
    lengths = lengths[lengths >= 100]
    if mean_power is not None:
        taus = stats.tau_vs_length_from_power(
            mean_power[0], int(mean_power[1]), n_steps, lengths
        )
    else:
        taus = np.array([stats.integrated_time(chain[:n], quiet=True) for n in lengths])
    fig, ax = plt.subplots(figsize=(6, 4))
    for d in range(taus.shape[1]):
        ax.plot(lengths, taus[:, d], "o-", ms=3, label=f"param {d}")
    ax.plot(lengths, lengths / 50.0, "k--", label="N/50 threshold")
    ax.set_xscale("log")
    ax.set_xlabel("chain length")
    ax.set_ylabel(r"integrated autocorrelation time $\tau$")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "autocorrelation_time.pdf"))
    plt.close(fig)


def _plot_autocorrelation_per_walker(
    chain: np.ndarray,
    log_prob: np.ndarray,
    names: list[str],
    plot_dir: str,
    sampler_tau=None,
) -> None:
    """Per-walker integrated autocorrelation time, mean +- std over walkers for
    each parameter and the log posterior (reference plot_mcmc.py:151-233), plus
    a comparison bar chart for the sampler's own walker-averaged estimate."""
    tau_p, rel_p = stats.integrated_time_per_walker(chain)
    for w in np.nonzero(~rel_p.all(axis=1))[0]:
        logger.info(f"Autocorrelation time unreliable for walker {w} (chain < 50 tau)")
    tau_lp, _ = stats.integrated_time_per_walker(log_prob[:, :, None])

    mean_tau = np.concatenate([tau_p.mean(axis=0), tau_lp.mean(axis=0)])
    std_tau = np.concatenate([tau_p.std(axis=0), tau_lp.std(axis=0)])
    labels = list(names) + ["log_posterior"]

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.bar(labels, mean_tau, yerr=std_tau, color="steelblue")
    ax.set_ylabel("Autocorrelation time")
    ax.set_title("Autocorrelation time (mean, stdev over walkers)")
    ax.tick_params(axis="x", labelsize=7)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "autocorrelation_time_per_walker.pdf"))
    plt.close(fig)

    if sampler_tau is not None and not (np.isscalar(sampler_tau) and sampler_tau is None):
        sampler_tau = np.atleast_1d(np.asarray(sampler_tau, float))
        if sampler_tau.shape[0] == len(names):
            fig, ax = plt.subplots(figsize=(10, 6))
            ax.bar(list(names), sampler_tau, color="darkorange")
            ax.set_ylabel("Autocorrelation time")
            ax.set_title("Sampler estimate (walker-averaged)")
            ax.tick_params(axis="x", labelsize=7)
            fig.tight_layout()
            fig.savefig(os.path.join(plot_dir, "autocorrelation_time_sampler.pdf"))
            plt.close(fig)


def _plot_pairplot(
    chain: np.ndarray,
    names: list[str],
    plot_dir: str,
    max_samples: int = 20000,
    confidence: float | None = None,
    holdout_point: np.ndarray | None = None,
    filename: str = "pairplot_posterior.pdf",
) -> bool | None:
    """Posterior pairplot. With ``confidence``, shades the HPD credible interval
    on each diagonal; with ``holdout_point``, overlays the truth marker and
    returns whether every truth component lies inside its HPDI (reference
    plot_mcmc.py:236-290, the holdout closure check)."""
    flat = chain.reshape(-1, chain.shape[-1])
    if flat.shape[0] > max_samples:
        idx = np.random.default_rng(0).choice(flat.shape[0], max_samples, replace=False)
        flat = flat[idx]
    d = flat.shape[1]
    theta_closure: bool | None = None if holdout_point is None else True
    fig, axes = plt.subplots(d, d, figsize=(2.2 * d, 2.2 * d))
    for i in range(d):
        for j in range(d):
            ax = axes[i][j]
            if i == j:
                ax.hist(flat[:, i], bins=50, color="steelblue")
                if confidence is not None:
                    lo, hi = stats.credible_interval(flat[:, i], confidence, interval_type="hpd")
                    ax.axvspan(lo, hi, color="k", alpha=0.1)
                    if holdout_point is not None:
                        truth = holdout_point[i]
                        ax.axvline(truth, color="k", lw=1)
                        if truth < lo or truth > hi:
                            theta_closure = False
            elif i > j:
                ax.hist2d(flat[:, j], flat[:, i], bins=40, cmap="Blues")
                if holdout_point is not None:
                    ax.scatter([holdout_point[j]], [holdout_point[i]], color="k", s=12, zorder=3)
            else:
                ax.axis("off")
            if i == d - 1:
                ax.set_xlabel(names[j], fontsize=7)
            if j == 0 and i > 0:
                ax.set_ylabel(names[i], fontsize=7)
            ax.tick_params(labelsize=5)
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, filename))
    plt.close(fig)
    return theta_closure


def _plot_traces(chain: np.ndarray, names: list[str], plot_dir: str) -> None:
    d = chain.shape[-1]
    fig, axes = plt.subplots(d, 1, figsize=(8, 1.6 * d), sharex=True, squeeze=False)
    for i in range(d):
        ax = axes[i][0]
        for w in range(0, chain.shape[1], max(1, chain.shape[1] // 10)):
            ax.plot(chain[:, w, i], lw=0.3, alpha=0.6)
        ax.set_ylabel(names[i], fontsize=7)
    axes[-1][0].set_xlabel("step")
    fig.tight_layout()
    fig.savefig(os.path.join(plot_dir, "traces.pdf"))
    plt.close(fig)


def _plot_posterior_observables(chain: np.ndarray, config, plot_dir: str, n_samples: int = 100) -> None:
    """Design-prediction spaghetti vs emulator predictions at posterior samples,
    overlaid on experimental data (reference plot_mcmc.py:319-375)."""
    from bayesian_inference_tpu.io import observables as obs_io
    from bayesian_inference_tpu.models import emulator as emulator_mod
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig
    from bayesian_inference_tpu.plots.utils import observable_panels

    emulation_config = EmulationConfig.from_config_file(
        analysis_name=config.analysis_name,
        parameterization=config.parameterization,
        analysis_config=config.analysis_config,
        config_file=config.config_file,
    )
    results = emulation_config.read_all_emulator_groups()
    # reference plot_mcmc.py:327-330 reads the configured observables file
    observables = hdf5.read_dict_from_h5(
        config.output_dir, config.observables_filename, verbose=False
    )
    sorted_labels = obs_io.sorted_observable_list_from_dict(
        observables, observable_filter=emulation_config.observable_filter
    )

    flat = chain.reshape(-1, chain.shape[-1])
    rng = np.random.default_rng(0)
    idx = rng.choice(flat.shape[0], min(n_samples, flat.shape[0]), replace=False)
    posterior_pred = emulator_mod.predict(flat[idx], emulation_config,
                                          emulation_group_results=results)

    design_Y = obs_io.predictions_matrix_from_h5(
        config.output_dir, config.observables_filename,
        observable_filter=emulation_config.observable_filter,
    )

    observable_panels(
        plot_list=[{"central_value": design_Y}, {"central_value": posterior_pred["central_value"]}],
        labels=["design predictions", "posterior emulated"],
        colors=["gray", "steelblue"],
        config=config,
        plot_dir=plot_dir,
        filename="posterior_observables.pdf",
        observables=observables,
        sorted_labels=sorted_labels,
        ylabel="RAA",
    )
