"""Per-stage configuration classes over the reference YAML schema.

The YAML schema (config/jet_substructure.yaml) is preserved verbatim — stage
toggles, `analyses.<name>.parameters.{preprocessing,emulators,mcmc,closure}`,
parameterization priors, validation split, cuts, exclusion lists. Only the
implementation of the classes is new (reference: emulation.py:551-709,
mcmc.py:207-245, preprocess_input_data.py:477-502).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any

import yaml

from bayesian_inference_tpu.io.observables import ObservableFilter
from bayesian_inference_tpu.ops.gram import KernelConfig


def load_yaml(path: str | Path) -> dict[str, Any]:
    with open(path) as stream:
        return yaml.safe_load(stream)


@dataclasses.dataclass
class EmulationGroupConfig:
    """Settings for one emulation group (one PCA + GP stack over an observable subset)."""

    analysis_name: str
    parameterization: str
    analysis_config: dict[str, Any]
    config_file: str
    group_name: str | None = None

    # Derived fields
    config: dict[str, Any] = dataclasses.field(init=False)
    observable_table_dir: str = dataclasses.field(init=False)
    observable_config_dir: str = dataclasses.field(init=False)
    observables_filename: str = dataclasses.field(init=False)
    force_retrain: bool = dataclasses.field(init=False)
    n_pc: int = dataclasses.field(init=False)
    max_n_components_to_calculate: int | None = dataclasses.field(init=False)
    active_kernels: dict[str, Any] = dataclasses.field(init=False)
    n_restarts: int = dataclasses.field(init=False)
    alpha: float = dataclasses.field(init=False)
    cross_validation: bool = dataclasses.field(init=False)
    cross_validation_k: int = dataclasses.field(init=False)
    observable_filter: ObservableFilter | None = dataclasses.field(init=False)
    output_dir: str = dataclasses.field(init=False)
    emulation_outputfile: str = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self.config = load_yaml(self.config_file)
        self.observable_table_dir = self.config["observable_table_dir"]
        self.observable_config_dir = self.config["observable_config_dir"]
        self.observables_filename = self.config["observables_filename"]

        emulators_cfg = self.analysis_config["parameters"]["emulators"]
        group_cfg = emulators_cfg if self.group_name is None else emulators_cfg[self.group_name]

        self.force_retrain = group_cfg["force_retrain"]
        self.n_pc = group_cfg["n_pc"]
        self.max_n_components_to_calculate = group_cfg.get("max_n_components_to_calculate", None)

        self.active_kernels = {k: group_cfg["kernels"][k] for k in group_cfg["kernels"]["active"]}
        base = [k for k in ("matern", "rbf") if k in self.active_kernels]
        assert len(base) == 1, "Must provide exactly one of 'matern', 'rbf' kernel"
        if "noise" in self.active_kernels:
            noise = self.active_kernels["noise"]
            assert noise.get("type") == "white", "Unsupported noise kernel"
            assert set(noise["args"]) == {"noise_level", "noise_level_bounds"}

        self.n_restarts = group_cfg["GPR"]["n_restarts"]
        self.alpha = group_cfg["GPR"]["alpha"]
        # k-fold emulator cross-validation: declared-but-unimplemented in the
        # reference (jet_substructure.yaml:85-90, "TODO: Cross-validation");
        # implemented in models/cv.py. Same YAML keys and defaults.
        self.cross_validation = bool(group_cfg.get("cross_validation", False))
        self.cross_validation_k = int(group_cfg.get("cross_validation_k", 5))

        include = group_cfg.get("observable_list", [])
        exclude = group_cfg.get("observable_exclude_list", [])
        self.observable_filter = (
            ObservableFilter(include_list=include, exclude_list=exclude)
            if (include or exclude)
            else None
        )

        self.output_dir = os.path.join(
            self.config["output_dir"], f"{self.analysis_name}_{self.parameterization}"
        )
        name = "emulation.pkl" if self.group_name is None else f"emulation_group_{self.group_name}.pkl"
        self.emulation_outputfile = os.path.join(self.output_dir, name)

    # ---- kernel/fit plumbing into the JAX stack --------------------------------

    def kernel_config(self) -> KernelConfig:
        nu = self.active_kernels["matern"]["nu"] if "matern" in self.active_kernels else None
        return KernelConfig(
            nu=nu,
            with_noise="noise" in self.active_kernels,
            with_constant="constant" in self.active_kernels,
        )

    def parameter_bounds(self) -> tuple[list[float], list[float]]:
        p = self.analysis_config["parameterization"][self.parameterization]
        return p["min"], p["max"]

    def fit_spec(self, n_iters: int = 100, dtype=None):
        from bayesian_inference_tpu.models.gp_fit import spec_from_reference_config
        import jax
        import jax.numpy as jnp

        if dtype is None:
            dtype = jax.dtypes.canonicalize_dtype(jnp.float64)
        pmin, pmax = self.parameter_bounds()
        base_key = "matern" if "matern" in self.active_kernels else "rbf"
        kwargs: dict[str, Any] = {
            "length_scale_bounds_factor": tuple(self.active_kernels[base_key]["length_scale_bounds_factor"]),
        }
        if "noise" in self.active_kernels:
            kwargs["noise_level"] = self.active_kernels["noise"]["args"]["noise_level"]
            kwargs["noise_level_bounds"] = tuple(self.active_kernels["noise"]["args"]["noise_level_bounds"])
        if "constant" in self.active_kernels:
            kwargs["constant_value"] = self.active_kernels["constant"]["constant_value"]
            kwargs["constant_value_bounds"] = tuple(self.active_kernels["constant"]["constant_value_bounds"])
        return spec_from_reference_config(
            self.kernel_config(),
            param_min=pmin,
            param_max=pmax,
            n_restarts=self.n_restarts,
            n_iters=n_iters,
            alpha_jitter=self.alpha,
            dtype=dtype,
            **kwargs,
        )


@dataclasses.dataclass
class EmulationConfig:
    """All emulation groups of one analysis x parameterization."""

    analysis_name: str
    parameterization: str
    config_file: str
    analysis_config: dict[str, Any]
    emulation_groups_config: dict[str, EmulationGroupConfig] = dataclasses.field(default_factory=dict)
    config: dict[str, Any] = dataclasses.field(init=False)
    observable_table_dir: str = dataclasses.field(init=False)
    observables_filename: str = dataclasses.field(init=False)
    output_dir: str = dataclasses.field(init=False)
    _observable_filter: ObservableFilter | None = dataclasses.field(init=False, default=None)

    def __post_init__(self) -> None:
        self.config = load_yaml(self.config_file)
        self.observable_table_dir = self.config["observable_table_dir"]
        self.observables_filename = self.config["observables_filename"]
        self.output_dir = os.path.join(
            self.config["output_dir"], f"{self.analysis_name}_{self.parameterization}"
        )

    @classmethod
    def from_config_file(
        cls, analysis_name: str, parameterization: str, config_file: str, analysis_config: dict[str, Any]
    ) -> "EmulationConfig":
        c = cls(
            analysis_name=analysis_name,
            parameterization=parameterization,
            config_file=str(config_file),
            analysis_config=analysis_config,
        )
        c.emulation_groups_config = {
            name: EmulationGroupConfig(
                analysis_name=analysis_name,
                parameterization=parameterization,
                analysis_config=analysis_config,
                config_file=str(config_file),
                group_name=name,
            )
            for name in analysis_config["parameters"]["emulators"]
        }
        return c

    @property
    def observable_filter(self) -> ObservableFilter:
        """Merged include/exclude over all groups + the global exclude list."""
        if self._observable_filter is None:
            include: list[str] = []
            exclude: list[str] = list(self.config.get("global_observable_exclude_list", []))
            for g in self.emulation_groups_config.values():
                if g.observable_filter is not None:
                    include.extend(g.observable_filter.include_list)
                    exclude.extend(g.observable_filter.exclude_list)
            self._observable_filter = ObservableFilter(include_list=include, exclude_list=exclude)
        return self._observable_filter

    def read_all_emulator_groups(self) -> dict[str, dict[str, Any]]:
        from bayesian_inference_tpu.models.emulator import read_emulators

        return {
            name: read_emulators(cfg) for name, cfg in self.emulation_groups_config.items()
        }


@dataclasses.dataclass
class MCMCConfig:
    analysis_name: str
    parameterization: str
    analysis_config: dict[str, Any]
    config_file: str
    closure_index: int = -1

    config: dict[str, Any] = dataclasses.field(init=False)
    observable_table_dir: str = dataclasses.field(init=False)
    observables_filename: str = dataclasses.field(init=False)
    n_walkers: int = dataclasses.field(init=False)
    n_burn_steps: int = dataclasses.field(init=False)
    n_sampling_steps: int = dataclasses.field(init=False)
    n_logging_steps: int = dataclasses.field(init=False)
    checkpoint_every: int | None = dataclasses.field(init=False)
    likelihood_mode: str = dataclasses.field(init=False)
    chain_transfer: str = dataclasses.field(init=False)
    confidence: float = dataclasses.field(init=False)
    output_dir: str = dataclasses.field(init=False)
    mcmc_output_dir: str = dataclasses.field(init=False)
    mcmc_outputfile: str = dataclasses.field(init=False)
    sampler_outputfile: str = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self.config = load_yaml(self.config_file)
        self.observable_table_dir = self.config["observable_table_dir"]
        self.observables_filename = self.config["observables_filename"]

        mcmc = self.analysis_config["parameters"]["mcmc"]
        self.n_walkers = mcmc["n_walkers"]
        self.n_burn_steps = mcmc["n_burn_steps"]
        self.n_sampling_steps = mcmc["n_sampling_steps"]
        self.n_logging_steps = mcmc["n_logging_steps"]
        # Optional step-granular checkpoint cadence for the production run
        # (resumable mid-chain — the capability the reference lists as an
        # open TODO, mcmc.py:69-70). Absent/0 keeps the default dispatch.
        self.checkpoint_every = int(mcmc.get("checkpoint_every", 0) or 0) or None
        # 'block' = reference-parity per-observable covariance blocks;
        # 'lowrank' = full cross-observable covariance via the Woodbury identity
        self.likelihood_mode = mcmc.get("likelihood_mode", "block")
        # Opt-in chain-download quantization: 'uint16' transfers the walker
        # coordinates as uint16 in prior-box units (2x fewer bytes over the
        # device->host transfer; ~range/65535 absolute rounding,
        # dequantized before mcmc.h5 — docs/PARITY.md records the posterior
        # deltas). Default '' keeps the lossless transfer.
        # BIQ_CHAIN_TRANSFER overrides for benches.
        self.chain_transfer = os.environ.get(
            "BIQ_CHAIN_TRANSFER", mcmc.get("chain_transfer", "") or ""
        ).lower()

        # Closure credible level for HPDI overlays on posterior pairplots
        # (reference plot_mcmc.py:272 uses config.confidence). Configs may list
        # several levels (rehlers.yaml); the first is used for plots.
        conf = self.analysis_config["parameters"].get("closure", {}).get("confidence", 0.9)
        self.confidence = float(conf[0] if isinstance(conf, (list, tuple)) else conf)

        self.output_dir = os.path.join(
            self.config["output_dir"], f"{self.analysis_name}_{self.parameterization}"
        )
        if self.closure_index < 0:
            self.mcmc_output_dir = self.output_dir
        else:
            self.mcmc_output_dir = os.path.join(self.output_dir, f"closure/results/{self.closure_index}")
        self.mcmc_outputfile = os.path.join(self.mcmc_output_dir, "mcmc.h5")
        self.sampler_outputfile = os.path.join(self.mcmc_output_dir, "mcmc_sampler.pkl")

    def parameterization_spec(self) -> dict[str, Any]:
        return self.analysis_config["parameterization"][self.parameterization]


@dataclasses.dataclass
class PreprocessingConfig:
    analysis_name: str
    parameterization: str
    analysis_config: dict[str, Any]
    config_file: str

    config: dict[str, Any] = dataclasses.field(init=False)
    outlier_n_RMS: float = dataclasses.field(init=False)
    interpolation_method: str = dataclasses.field(init=False)
    max_n_feature_outliers_to_interpolate: int = dataclasses.field(init=False)
    output_dir: str = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self.config = load_yaml(self.config_file)
        smoothing = self.analysis_config["parameters"]["preprocessing"]["smoothing"]
        self.outlier_n_RMS = smoothing["outlier_n_RMS"]
        self.interpolation_method = smoothing["interpolation_method"]
        if self.interpolation_method not in ("linear", "cubic_spline"):
            raise ValueError(f"Unrecognized interpolation method {self.interpolation_method}")
        self.max_n_feature_outliers_to_interpolate = smoothing["max_n_feature_outliers_to_interpolate"]
        self.output_dir = os.path.join(
            self.config["output_dir"], f"{self.analysis_name}_{self.parameterization}"
        )
