"""Production-scale closure-test benchmark on one GPU.

Runs the FULL batched closure sweep — every validation point of the
production-width profile (30 points x 100 walkers x burn-in + 50,000 steps)
vmapped into one device program — and writes ``output/CLOSURE_BENCH.json``:
wall-clock, point-steps/s, slab/HBM accounting, the device. This is the
reference's sequential 30-full-MCMC loop (steer_analysis.py:174-181) as a
single-device batch.

Prereq: ``python bench.py`` (or BENCH_PROFILE=production) has left fitted
emulator artifacts in output/bench_production.

Protocol: one UNTIMED warm-up closure run of a single dispatch chunk with
identical program shapes (same chunk size, same burn-in lengths) absorbs the
compiles, then the timed full run executes entirely warm.

Env knobs: BENCH_CLOSURE_STEPS / BENCH_CLOSURE_WALKERS / BENCH_CLOSURE_POINTS
shrink the workload; BENCH_CLOSURE_CHUNK sets the dispatch chunk (default
1000); BIQ_CHAIN_TRANSFER=uint16 halves the download bytes (see
docs/PARITY.md); BENCH_CLOSURE_WARMUP=0 skips the warm-up.
BENCH_CLOSURE_MODE=lowrank benches the exact full-covariance Woodbury
likelihood (writes output/CLOSURE_BENCH_LOWRANK.json).
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO / "src"))

import jax

if os.environ.get("BIQ_PLATFORM"):  # smoke tests on CPU
    jax.config.update("jax_platforms", os.environ["BIQ_PLATFORM"])

from bayesian_inference_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()

import logging

logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                    format="%(asctime)s %(name)s: %(message)s")

import numpy as np
import yaml

from bayesian_inference_tpu.mcmc.runner import run_closure_batch
from bayesian_inference_tpu.pipeline.configs import MCMCConfig

N_STEPS = int(os.environ.get("BENCH_CLOSURE_STEPS", "50000"))
N_WALKERS = int(os.environ.get("BENCH_CLOSURE_WALKERS", "100"))
N_POINTS = int(os.environ.get("BENCH_CLOSURE_POINTS", "0") or 0)  # 0 = all
CHUNK = int(os.environ.get("BENCH_CLOSURE_CHUNK", "1000"))
MODE = os.environ.get("BENCH_CLOSURE_MODE", "block")
assert MODE in ("block", "lowrank"), MODE

workdir = REPO / "output" / "bench_production"
if not (workdir / "bench.yaml").exists():
    sys.exit("run `python bench.py` first (needs output/bench_production artifacts)")
cfg_yaml = yaml.safe_load((workdir / "bench.yaml").read_text())
analysis_config = cfg_yaml["analyses"]["bench"]
analysis_config["parameters"]["mcmc"]["n_sampling_steps"] = N_STEPS
analysis_config["parameters"]["mcmc"]["n_walkers"] = N_WALKERS


def _mcmc_config() -> MCMCConfig:
    return MCMCConfig(
        analysis_name="bench", parameterization="exponential",
        analysis_config=analysis_config, config_file=str(workdir / "bench.yaml"),
    )


config = _mcmc_config()
v0, v1 = analysis_config["validation_indices"]
P = (v1 - v0) if not N_POINTS else N_POINTS
indices = range(P)
ndim = len(config.parameterization_spec()["names"])
slab_gb = N_STEPS * P * N_WALKERS * (ndim + 1) * 4 / 2**30

dev = jax.devices()[0]
print(f"# closure bench: {P} points x {N_WALKERS} walkers x {N_STEPS} steps "
      f"on {dev.device_kind} (full-batch slabs {slab_gb:.2f} GB f32)", file=sys.stderr)

if os.environ.get("BENCH_CLOSURE_WARMUP", "1") != "0":
    t0 = time.perf_counter()
    warm_cfg = _mcmc_config()
    warm_cfg.n_sampling_steps = CHUNK  # one dispatch chunk, same program shape
    run_closure_batch(warm_cfg, indices, seed=0, dispatch_chunk=CHUNK,
                      return_chains=False, mode=MODE)
    shutil.rmtree(os.path.join(warm_cfg.output_dir, "closure"), ignore_errors=True)
    print(f"# warm-up (untimed, compiles): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

t0 = time.perf_counter()
run_closure_batch(config, indices, seed=0, dispatch_chunk=CHUNK,
                  return_chains=False, mode=MODE,
                  checkpoint_every=max(1, N_STEPS // 4))
total_s = time.perf_counter() - t0

mem = {}
try:
    stats = dev.memory_stats() or {}
    mem = {k: int(v) for k, v in stats.items()
           if k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}
except Exception:  # not every backend exposes memory stats
    pass

line = {
    "metric": "production_closure_batch_walltime",
    "value": round(total_s, 1),
    "unit": "s",
    "likelihood_mode": MODE,
    "n_points": P,
    "n_walkers": N_WALKERS,
    "n_steps": N_STEPS,
    "point_steps_per_s": round(P * N_STEPS / total_s),
    "full_batch_slab_GB": round(slab_gb, 2),
    "dispatch_chunk": CHUNK,
    "chain_transfer": os.environ.get("BIQ_CHAIN_TRANSFER", "") or "lossless",
    "hbm_budget_MB": int(os.environ.get("BIQ_CLOSURE_HBM_BUDGET_MB", "8192")),
    "device": dev.device_kind,
    **({"memory_stats": mem} if mem else {}),
}
out_name = "CLOSURE_BENCH.json" if MODE == "block" else "CLOSURE_BENCH_LOWRANK.json"
(REPO / "output" / out_name).write_text(json.dumps(line, indent=1) + "\n")
print(json.dumps(line))
