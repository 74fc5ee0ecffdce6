"""Pipeline orchestrator + CLI (reference steer_analysis.py).

Runs, per analysis x parameterization, the toggled stages:
initialize observables -> preprocess -> fit emulators -> MCMC -> closure tests,
then the plotting suite. All cross-stage communication goes through on-disk
artifacts (observables.h5, observables_preprocessed.h5, emulation*.pkl,
mcmc.h5) so stages can be re-run independently.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
from pathlib import Path
from typing import Any

from bayesian_inference_tpu.io import hdf5, tables
from bayesian_inference_tpu.pipeline.configs import (
    EmulationConfig,
    MCMCConfig,
    PreprocessingConfig,
    load_yaml,
)
from bayesian_inference_tpu.utils.helpers import setup_logging, stage_timer

logger = logging.getLogger(__name__)


class SteerAnalysis:
    """Top-level driver: loads the YAML, loops analyses x parameterizations."""

    def __init__(self, config_file: str):
        self.config_file = config_file
        config = load_yaml(config_file)
        self.config = config
        self.output_dir = config["output_dir"]
        os.makedirs(self.output_dir, exist_ok=True)

        self.observable_table_dir = config["observable_table_dir"]
        self.observable_config_dir = config["observable_config_dir"]

        self.initialize_observables = config["initialize_observables"]
        self.preprocess_input_data = config["preprocess_input_data"]
        self.fit_emulators = config["fit_emulators"]
        self.run_mcmc = config["run_mcmc"]
        self.run_closure_tests = config["run_closure_tests"]
        self.plot = config["plot"]
        self.analyses = config["analyses"]
        # Wall seconds per stage, keyed like the log lines
        # ("fit_emulators[<analysis>/<parameterization>]", ...), and the
        # run_mcmc result (incl. its per-phase "timings") per run directory.
        self.stage_seconds: dict[str, float] = {}
        self.mcmc_results: dict[str, dict[str, Any]] = {}

    # ------------------------------------------------------------------
    def run_analysis(self) -> None:
        logging.getLogger().addHandler(
            logging.FileHandler(os.path.join(self.output_dir, "steer_analysis.log"), "w")
        )
        shutil.copy(self.config_file, Path(self.output_dir) / "steer_analysis_config.yaml")

        for analysis_name, analysis_config in self.analyses.items():
            for parameterization in analysis_config["parameterizations"]:
                self._run_single(analysis_name, parameterization, analysis_config)

        self._run_plots()

    # ------------------------------------------------------------------
    def _run_single(self, analysis_name: str, parameterization: str, analysis_config: dict[str, Any]) -> None:
        run_dir = os.path.join(self.output_dir, f"{analysis_name}_{parameterization}")

        if self.initialize_observables:
            with stage_timer(f"initialize[{analysis_name}/{parameterization}]", logger, self.stage_seconds):
                observables = tables.initialize_observables_dict_from_tables(
                    self.observable_table_dir, analysis_config, parameterization
                )
                hdf5.write_dict_to_h5(observables, run_dir, filename="observables.h5")

        if not self.initialize_observables and not os.path.exists(os.path.join(run_dir, "observables.h5")):
            # Convenience for pre-aggregated observables: stage an existing
            # observables.h5 from the observable_config_dir.
            staged = os.path.join(self.observable_config_dir, "observables.h5")
            if os.path.exists(staged):
                os.makedirs(run_dir, exist_ok=True)
                shutil.copy(staged, os.path.join(run_dir, "observables.h5"))
                logger.info(f"Staged pre-aggregated observables.h5 from {staged}")

        if self.preprocess_input_data:
            with stage_timer(f"preprocess[{analysis_name}/{parameterization}]", logger, self.stage_seconds):
                from bayesian_inference_tpu.preprocess import preprocess

                preprocessing_config = PreprocessingConfig(
                    analysis_name=analysis_name,
                    parameterization=parameterization,
                    analysis_config=analysis_config,
                    config_file=self.config_file,
                )
                smoothed = preprocess(preprocessing_config)
                hdf5.write_dict_to_h5(smoothed, run_dir, filename="observables_preprocessed.h5")

        if self.fit_emulators:
            with stage_timer(f"fit_emulators[{analysis_name}/{parameterization}]", logger, self.stage_seconds):
                from bayesian_inference_tpu.models import emulator

                emulation_config = EmulationConfig.from_config_file(
                    analysis_name=analysis_name,
                    parameterization=parameterization,
                    analysis_config=analysis_config,
                    config_file=self.config_file,
                )
                emulator.fit_emulators(emulation_config)

            if any(
                g.cross_validation
                for g in emulation_config.emulation_groups_config.values()
            ):
                # k-fold emulator CV (the reference's open TODO,
                # jet_substructure.yaml:85-90) — see models/cv.py.
                with stage_timer(f"cross_validation[{analysis_name}/{parameterization}]", logger, self.stage_seconds):
                    from bayesian_inference_tpu.models.cv import cross_validate

                    cross_validate(emulation_config)

        if self.run_mcmc:
            with stage_timer(f"mcmc[{analysis_name}/{parameterization}]", logger, self.stage_seconds):
                from bayesian_inference_tpu.mcmc.runner import run_mcmc

                mcmc_config = MCMCConfig(
                    analysis_name=analysis_name,
                    parameterization=parameterization,
                    analysis_config=analysis_config,
                    config_file=self.config_file,
                )
                self.mcmc_results[run_dir] = run_mcmc(
                    mcmc_config, checkpoint_every=mcmc_config.checkpoint_every
                )

        if self.run_closure_tests:
            n_points = analysis_config["validation_indices"][1] - analysis_config["validation_indices"][0]
            with stage_timer(f"closure[{analysis_name}/{parameterization}] x{n_points}", logger, self.stage_seconds):
                mcmc_config = MCMCConfig(
                    analysis_name=analysis_name,
                    parameterization=parameterization,
                    analysis_config=analysis_config,
                    config_file=self.config_file,
                )
                # All validation-point MCMCs vmapped into one on-chip program
                # (the reference loops full runs sequentially,
                # steer_analysis.py:174-181). Both likelihood modes batch;
                # chains stream to the per-point artifacts and the batch
                # checkpoints every quarter for resume.
                from bayesian_inference_tpu.mcmc.runner import run_closure_batch

                run_closure_batch(
                    mcmc_config, range(n_points),
                    checkpoint_every=max(1, mcmc_config.n_sampling_steps // 4),
                    return_chains=False,
                )

    # ------------------------------------------------------------------
    def _run_plots(self) -> None:
        if not any(self.plot.values()):
            return
        from bayesian_inference_tpu import plots

        for analysis_name, analysis_config in self.analyses.items():
            for parameterization in analysis_config["parameterizations"]:
                emulation_config = EmulationConfig.from_config_file(
                    analysis_name=analysis_name,
                    parameterization=parameterization,
                    analysis_config=analysis_config,
                    config_file=self.config_file,
                )
                mcmc_config = MCMCConfig(
                    analysis_name=analysis_name,
                    parameterization=parameterization,
                    analysis_config=analysis_config,
                    config_file=self.config_file,
                )
                if self.plot.get("input_data"):
                    plots.input_data.plot(emulation_config)
                if self.plot.get("emulators"):
                    plots.emulation.plot(emulation_config)
                if self.plot.get("mcmc"):
                    plots.mcmc.plot(mcmc_config)
                if self.plot.get("qhat"):
                    plots.qhat.plot(mcmc_config)
                if self.plot.get("closure_tests"):
                    plots.closure.plot(mcmc_config)

        if self.plot.get("across_analyses"):
            plots.analyses.plot(self.analyses, self.config_file, self.output_dir)


def main() -> None:
    setup_logging(level=logging.INFO)
    parser = argparse.ArgumentParser(description="Bayesian inference of jet transport properties (JAX)")
    parser.add_argument(
        "-c", "--configFile", action="store", type=str, required=True,
        help="Path of YAML config file for the analysis",
    )
    parser.add_argument(
        "--profile", type=str, default=None, metavar="TRACE_DIR",
        help="Write a jax.profiler device trace for the run to TRACE_DIR",
    )
    parser.add_argument(
        "--platform", type=str, default=os.environ.get("BIQ_PLATFORM"),
        help="Force a jax platform (e.g. 'cpu' for a host-only run).",
    )
    parser.add_argument(
        "--x64", action="store_true", default=bool(os.environ.get("BIQ_X64")),
        help="Enable float64 (CPU cross-check runs)",
    )
    args = parser.parse_args()
    if args.platform or args.x64:
        import jax

        if args.platform:
            jax.config.update("jax_platforms", args.platform)
        if args.x64:
            jax.config.update("jax_enable_x64", True)
    if not os.path.exists(args.configFile):
        raise ValueError(f"File {args.configFile} does not exist!")
    from bayesian_inference_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    from bayesian_inference_tpu.utils.profiling import device_trace

    with device_trace(args.profile):
        SteerAnalysis(config_file=args.configFile).run_analysis()


if __name__ == "__main__":
    main()
