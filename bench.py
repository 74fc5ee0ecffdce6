"""North-star benchmark (BASELINE.json): GP hyperparameter fit + 50,000-step /
100-walker ensemble MCMC with the full GP-emulated Gaussian likelihood, on one
NVIDIA GPU. Target: < 60 s wall-clock (the reference runs the same sampling
workload across a 20-core node via emcee + multiprocessing).

Prints ONE JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": 60/seconds,
   "device": {"platform", "kind", "count", "card"}, ...}
where "card" is nvidia-smi's name and power limit. Exits non-zero unless JAX
runs on a GPU.

Two data profiles, both at full production COMPUTE scale (41 GPs = 5/11/25
PCs x 51 restarts, 100 walkers x 1,000+50,000 steps):

* ``production`` (headline): synthetic production-WIDTH table set at the
  reference's full data scale (~144 observables / ~1,650 features, families
  and bin counts per jet_substructure.yaml:199-266), generated by
  io/synthetic.py and ingested through io/tables.py.
* ``fixture``: the bundled real-data fixture (16 observables / 215 features).

``value``/``vs_baseline`` use the MEDIAN of BENCH_REPS (default 5) timed
repetitions of (fit + MCMC); the JSON also reports per-rep values, the min,
and a per-phase breakdown (fit / burn / production / autocorr / write).

Measurement protocol: every device program is executed once on dummy values
of the real shapes BEFORE the timed section (warm-up, duration printed to
stderr), so compilation is set-up time and not part of the timed reps.
BENCH_WARMUP=0 reverts to cold-start timing.

Env knobs for smoke tests: BENCH_PROFILE=production|fixture|both (default
both), BENCH_REPS, BENCH_WALKERS, BENCH_BURN, BENCH_STEPS, BENCH_RESTARTS,
BENCH_OPT_ITERS. BENCH_LIKELIHOOD_MODE=lowrank benches the full-covariance
Woodbury likelihood; BENCH_CHAIN_TRANSFER=lossless reverts the production
profile's uint16 chain transfer.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent
sys.path.insert(0, str(REPO / "src"))

import jax
import numpy as np
import yaml

from bayesian_inference_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

import logging

logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="%(asctime)s %(name)s: %(message)s")

N_WALKERS = int(os.environ.get("BENCH_WALKERS", "100"))
N_BURN = int(os.environ.get("BENCH_BURN", "1000"))
N_STEPS = int(os.environ.get("BENCH_STEPS", "50000"))
N_RESTARTS = int(os.environ.get("BENCH_RESTARTS", "50"))
N_OPT_ITERS = int(os.environ.get("BENCH_OPT_ITERS", "60"))
# A 5-rep median absorbs up to two outlier reps (host noise).
N_REPS = int(os.environ.get("BENCH_REPS", "5"))
PROFILE = os.environ.get("BENCH_PROFILE", "both")

_EXP_MIN = [0.1, 1, 0.006737946999085467, 0.006737946999085467, 0, 0.049787068367863944]
_EXP_MAX = [0.5, 10, 10, 10, 1.5, 100]

# Fixture-profile groups: production per-group PC counts over the bundled
# real-data observables.
FIXTURE_GROUPS = {
    "jet_like_group": {"n_pc": 5, "observable_list": ["pt_ch_alice", "pt_ch_star"]},
    "mid_group": {"n_pc": 11, "observable_list": ["pt_ch_atlas", "pt_ch_cms"]},
    "large_group": {"n_pc": 25, "observable_list": ["pt_pi"]},
}

# Production-profile groups: the reference production analysis's three
# emulation groups (jet_substructure.yaml:246-266) over the synthetic
# production-width table set.
PRODUCTION_GROUPS = {
    "jet_group": {"n_pc": 5, "observable_list": ["jet__pt_"]},
    "substructure_groomed_group": {"n_pc": 11, "observable_list": ["chjet__zg_", "chjet__tg_"]},
    "substructure_Dz_group": {"n_pc": 25, "observable_list": ["jet__Dz_"]},
}


def make_config(workdir: Path, groups: dict, table_dir: str | None = None,
                exclude: list[int] | None = None, chain_transfer: str = "",
                likelihood_mode: str = "", n_walkers: int = N_WALKERS,
                n_burn: int = N_BURN, n_steps: int = N_STEPS,
                n_restarts: int = N_RESTARTS):
    """Write the analysis YAML for ``groups``; returns (path, analysis name,
    parameterization, analysis config, run directory)."""
    analysis_name, parameterization = "bench", "exponential"
    emulators = {
        name: {
            "force_retrain": True,
            "n_pc": g["n_pc"],
            "max_n_components_to_calculate": 30,
            "kernels": {
                "active": ["matern", "noise"],
                "matern": {"nu": 1.5, "length_scale_bounds_factor": [0.01, 100]},
                "noise": {"type": "white", "args": {"noise_level": 0.25, "noise_level_bounds": [0.0001, 1]}},
            },
            "GPR": {"n_restarts": n_restarts, "alpha": 1.0e-6},
            "observable_list": g["observable_list"],
        }
        for name, g in groups.items()
    }
    analysis_config = {
        "parameterizations": [parameterization],
        "sqrts_list": [200, 2760, 5020],
        "centrality_range": [0, 10],
        "parameterization": {
            parameterization: {
                "names": ["alpha_s", "Q0", "c_1", "c_2", "tau_0", "c_3"],
                "min": _EXP_MIN,
                "max": _EXP_MAX,
            }
        },
        "validation_indices": [200, 230],
        "parameters": {
            "emulators": emulators,
            "mcmc": {
                "n_walkers": n_walkers,
                "n_burn_steps": n_burn,
                "n_sampling_steps": n_steps,
                "n_logging_steps": 1000,
                **({"chain_transfer": chain_transfer} if chain_transfer else {}),
                **({"likelihood_mode": likelihood_mode} if likelihood_mode else {}),
            },
        },
    }
    if exclude:
        analysis_config["design_points_to_exclude"] = exclude
    config = {
        "output_dir": str(workdir / "output"),
        "initialize_observables": table_dir is not None,
        "preprocess_input_data": False,
        "fit_emulators": True,
        "run_mcmc": True,
        "run_closure_tests": False,
        "plot": {},
        "observable_table_dir": table_dir or str(REPO / "tests" / "test_data" / "tables"),
        "observable_config_dir": str(REPO / "tests" / "test_data"),
        "observables_filename": "observables.h5",
        "analyses": {analysis_name: analysis_config},
    }
    path = workdir / "bench.yaml"
    path.write_text(yaml.safe_dump(config))
    run_dir = workdir / "output" / f"{analysis_name}_{parameterization}"
    run_dir.mkdir(parents=True, exist_ok=True)
    if table_dir is None:
        shutil.copy(REPO / "tests" / "test_data" / "observables.h5", run_dir / "observables.h5")
    return path, analysis_name, parameterization, analysis_config, run_dir


def _warm_up(mcmc_config, emu_config):
    """Execute each device program once on dummy values (real shapes).

    Sampler programs: compiled from config-derived shape specs, then executed
    with a zero-valued placeholder likelihood (identity covariance blocks).
    Fit program: one fit_gps call on random PCs — populates the in-process jit
    cache, so the timed fit is pure execution.
    """
    import jax.numpy as jnp

    from bayesian_inference_tpu.mcmc import programs as programs_mod
    from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu.models import gp_fit
    from bayesian_inference_tpu.models.emulator import GroupSliceMap

    spec_names = mcmc_config.parameterization_spec()
    theta_min = np.asarray(spec_names["min"], float)
    theta_max = np.asarray(spec_names["max"], float)
    ndim = len(spec_names["names"])

    # Placeholder likelihood with executable (identity-block) values.
    placeholder = {
        name: programs_mod._placeholder_group_artifact(cfg)
        for name, cfg in emu_config.emulation_groups_config.items()
    }
    n_features = GroupSliceMap.learn(emu_config).n_features
    like_dummy = build_likelihood(
        emu_config, placeholder,
        {"y": np.zeros(n_features), "y_err": np.ones(n_features)},
        theta_min=theta_min, theta_max=theta_max,
        mode=getattr(mcmc_config, "likelihood_mode", "block"),
    )
    programs = programs_mod.SamplerPrograms(
        like_dummy, mcmc_config.n_walkers, ndim,
        programs_mod.chunk_sizes_for_config(mcmc_config),
    )
    programs.compile()
    key = jax.random.key(123)
    x0 = jax.random.uniform(
        key, (mcmc_config.n_walkers, ndim),
        minval=like_dummy.theta_min, maxval=like_dummy.theta_max,
        dtype=like_dummy.theta_min.dtype,
    )
    state = programs.init(key, like_dummy, x0)
    chain_by_size = {}
    for n in programs_mod.chunk_sizes_for_config(mcmc_config):
        state, ys = programs.chunk(state, like_dummy, n)
        chain_by_size[n] = ys[0]
    np.asarray(ys[2])

    # Post-production device programs (tau-spectrum/R-hat stats, uint16
    # quantize) would otherwise compile inside rep 0's timed production
    # phase. The stats input is the concatenation of the production chunk
    # list, so feed the same piece-list SHAPE by aliasing the warmed chunk
    # chains.
    from bayesian_inference_tpu.mcmc import runner as runner_mod

    n_total = mcmc_config.n_sampling_steps
    sizes = runner_mod._production_sizes(mcmc_config, None) or [n_total]
    if all(n in chain_by_size for n in sizes):
        runner_mod._device_chain_stats([chain_by_size[n] for n in sizes])
    quant = runner_mod._ChainQuantizer.from_config(mcmc_config, like_dummy)
    if quant is not None:
        quant.prewarm([(n, mcmc_config.n_walkers, ndim) for n in sorted(set(sizes))])

    # Fit program: same spec/shapes as the real fused fit.
    from bayesian_inference_tpu.io import observables as obs_io

    groups = list(emu_config.emulation_groups_config.values())
    fit_spec = groups[0].fit_spec(n_iters=N_OPT_ITERS)
    design = np.asarray(
        obs_io.design_array_from_h5(
            groups[0].output_dir, filename=groups[0].observables_filename
        )
    )
    k_total = sum(g.n_pc for g in groups)
    Y_dummy = np.random.default_rng(0).normal(size=(design.shape[0], k_total))
    Y_fit = jnp.asarray(np.asarray(Y_dummy))
    posts = gp_fit.fit_gps(fit_spec, jnp.asarray(design, Y_fit.dtype), Y_fit, jax.random.key(7))
    np.asarray(posts.lml)
    return programs


def _median_phases(reps: list[dict]) -> dict:
    keys = sorted({k for r in reps for k in r if k != "total"})
    return {k: round(statistics.median(r.get(k, 0.0) for r in reps), 3) for k in keys}


def run_profile(name: str, groups: dict, table_dir: str | None = None,
                chain_transfer: str = "", likelihood_mode: str = "") -> dict:
    """Warm up, then run N_REPS timed (fit + MCMC) repetitions of one profile."""
    from bayesian_inference_tpu.io import hdf5
    from bayesian_inference_tpu.io import tables as tables_mod
    from bayesian_inference_tpu.mcmc.runner import run_mcmc
    from bayesian_inference_tpu.models import emulator
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig, MCMCConfig

    workdir = REPO / "output" / f"bench_{name}"
    if workdir.exists():
        shutil.rmtree(workdir)
    workdir.mkdir(parents=True)
    exclude = [17, 43] if table_dir else None
    config_path, analysis_name, parameterization, analysis_config, run_dir = make_config(
        workdir, groups, table_dir, exclude, chain_transfer, likelihood_mode
    )

    result: dict = {"profile": name,
                    "chain_transfer": chain_transfer or "lossless",
                    "likelihood_mode": likelihood_mode or "block"}
    if table_dir is not None:
        t0 = time.perf_counter()
        obs = tables_mod.initialize_observables_dict_from_tables(
            table_dir, analysis_config, parameterization
        )
        hdf5.write_dict_to_h5(obs, str(run_dir), "observables.h5", verbose=False)
        result["ingest_s"] = round(time.perf_counter() - t0, 3)

    obs = hdf5.read_dict_from_h5(str(run_dir), "observables.h5", verbose=False)
    result["n_observables"] = len(obs["Prediction"])
    result["n_features"] = int(sum(p["y"].shape[0] for p in obs["Prediction"].values()))
    result["n_design"] = int(obs["Design"].shape[0])

    emu_config = EmulationConfig.from_config_file(
        analysis_name=analysis_name,
        parameterization=parameterization,
        config_file=str(config_path),
        analysis_config=analysis_config,
    )
    mcmc_config = MCMCConfig(
        analysis_name=analysis_name,
        parameterization=parameterization,
        analysis_config=analysis_config,
        config_file=str(config_path),
    )

    print(f"# [{name}] {result['n_observables']} observables / {result['n_features']} features"
          f" / design ({result['n_design']}, 6)", file=sys.stderr)

    programs = None
    if os.environ.get("BENCH_WARMUP", "1") != "0":
        t_w = time.perf_counter()
        programs = _warm_up(mcmc_config, emu_config)
        print(f"# [{name}] warm-up (untimed, compilation + first execution): "
              f"{time.perf_counter() - t_w:.2f}s", file=sys.stderr)

    # Analytic FLOP accounting (utils/flops.py): per-step count from the
    # likelihood's actual bucket/GP shapes, fit count from the restart
    # schedule — so the JSON carries tflops/MFU, not wall-clock alone.
    from bayesian_inference_tpu.mcmc import programs as programs_mod
    from bayesian_inference_tpu.utils import flops as flops_mod

    spec_names = mcmc_config.parameterization_spec()
    like_spec = (
        programs.like_spec
        if programs is not None
        else programs_mod.likelihood_shape_spec(
            emu_config,
            theta_min=np.asarray(spec_names["min"], float),
            theta_max=np.asarray(spec_names["max"], float),
            mode=getattr(mcmc_config, "likelihood_mode", "block"),
        )
    )
    step_flops = flops_mod.mcmc_step_flops(like_spec, N_WALKERS)
    n_design = result["n_design"]
    k_pcs = sum(g.n_pc for g in emu_config.emulation_groups_config.values())
    fit_flops = flops_mod.fit_total_flops(
        N=n_design, d=len(spec_names["names"]), k_pcs=k_pcs,
        n_restarts=N_RESTARTS, n_iters=N_OPT_ITERS,
    )

    reps: list[dict] = []
    for rep in range(N_REPS):
        t0 = time.perf_counter()
        emulator.fit_emulators(emu_config, n_opt_iters=N_OPT_ITERS)
        jax.effects_barrier()
        t_fit = time.perf_counter() - t0

        t1 = time.perf_counter()
        out = run_mcmc(mcmc_config, seed=rep, programs=programs)
        t_mcmc = time.perf_counter() - t1

        phases = {"fit": round(t_fit, 3)}
        phases.update({k: round(v, 3) for k, v in out.get("timings", {}).items()})
        phases["total"] = round(t_fit + t_mcmc, 3)
        af = float(np.mean(out["acceptance_fraction"]))
        print(f"# [{name}] rep {rep}: total {phases['total']:.2f}s "
              f"(fit {t_fit:.2f}, mcmc {t_mcmc:.2f}, {N_STEPS / t_mcmc:.0f} steps/s), "
              f"acceptance={af:.3f}", file=sys.stderr)
        reps.append(phases)

    totals = [r["total"] for r in reps]
    phases = _median_phases(reps)
    result.update({
        "value": round(statistics.median(totals), 3),
        "min": round(min(totals), 3),
        "reps": totals,
        "phases": phases,
    })

    # FLOPs/MFU: achieved rates over the measured (download-inclusive) phase
    # medians, i.e. a LOWER bound on device throughput.
    peak_tflops = flops_mod.device_peak_tflops()
    mcmc_s = phases.get("burn", 0.0) + phases.get("production", 0.0)
    fit_s = phases.get("fit", 0.0)
    mcmc_flops = step_flops * (N_STEPS + N_BURN)
    tflops = (mcmc_flops + fit_flops) / max(mcmc_s + fit_s, 1e-9) / 1e12
    result["flops"] = {
        "per_step": round(step_flops / 1e6, 2),            # MFLOP/step
        "fit_total": round(fit_flops / 1e12, 3),           # TFLOP
        "steps_per_s": round(N_STEPS / max(phases.get("production", 1e-9), 1e-9)),
        "mcmc_tflops": round(mcmc_flops / max(mcmc_s, 1e-9) / 1e12, 3),
        "fit_tflops": round(fit_flops / max(fit_s, 1e-9) / 1e12, 3),
        "tflops_achieved": round(tflops, 3),
        "peak_tflops_bf16": peak_tflops,
        "mfu": round(tflops / peak_tflops, 5),
    }
    return result


def main() -> None:
    from bayesian_inference_tpu.utils.device import card_name_and_power_limit, require_gpu

    device = require_gpu()
    device["card"] = card_name_and_power_limit()
    print(f"# bench device: {device}", file=sys.stderr)

    # BENCH_LIKELIHOOD_MODE=lowrank runs the full-covariance Woodbury
    # likelihood end-to-end (default: block = reference-parity workload).
    lmode = os.environ.get("BENCH_LIKELIHOOD_MODE", "")
    lmode = "" if lmode in ("", "block") else lmode

    profiles: dict[str, dict] = {}
    if PROFILE in ("fixture", "both"):
        profiles["fixture"] = run_profile("fixture", FIXTURE_GROUPS, likelihood_mode=lmode)
    if PROFILE in ("production", "both"):
        from bayesian_inference_tpu.io.synthetic import make_production_tables

        table_dir = REPO / "output" / "bench_production_tables"
        if not (table_dir / "Design").exists():
            make_production_tables(table_dir)
        # Production headline runs the uint16 chain transfer by default: the
        # quantization shift on any posterior quantile is < 0.5x the chain's
        # own MC error (docs/PARITY.md sign-off) and it halves the chain
        # download. BENCH_CHAIN_TRANSFER=lossless reverts; "chain_transfer"
        # rides the JSON line either way. The fixture profile stays lossless.
        transfer = os.environ.get("BENCH_CHAIN_TRANSFER", "uint16")
        profiles["production"] = run_profile(
            "production", PRODUCTION_GROUPS, str(table_dir),
            chain_transfer="" if transfer in ("", "lossless") else transfer,
            likelihood_mode=lmode,
        )

    # Headline = production-width median when available (the north-star claim
    # at true production DATA scale); fixture otherwise (smoke runs).
    head = profiles.get("production") or profiles["fixture"]
    line = {
        "metric": "gp_fit_plus_50k_step_100_walker_mcmc_walltime",
        "value": head["value"],
        "unit": "s",
        "vs_baseline": round(60.0 / head["value"], 3),
        **{k: head[k] for k in ("profile", "n_observables", "n_features", "min", "reps", "phases", "flops", "chain_transfer", "likelihood_mode")},
        "device": device,
    }
    for name, res in profiles.items():
        if res is not head:
            line[name] = {k: res[k] for k in
                          ("value", "min", "reps", "phases", "flops", "n_observables", "n_features")}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
