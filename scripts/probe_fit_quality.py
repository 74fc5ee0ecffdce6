"""Fit-schedule quality study: does a cheaper restart/halving/polish schedule
reach the same final LMLs?

CPU x64 (exact arithmetic — schedule effects only, no precision effects), on
the real fixture at the production fit SHAPE class (N=200 design points,
ndim=6). For each candidate schedule, fits k PCs x (n_restarts+1) instances
from the SAME seeds as the baseline and reports the per-PC final-LML delta
vs the baseline schedule (halving_iters=15, keep=4, n_iters=60 — the bench
defaults). A schedule is adoptable when max |dLML| is < ~0.1 nat on every PC
over every seed (differences far below emulator-quality relevance; the
halving-rejected restarts were never going to win).

Cost column: iteration-instances relative to baseline at the PRODUCTION batch
(R=51 restarts, k=41 PCs) — what the device fit phase actually pays.

Usage: python scripts/probe_fit_quality.py [n_seeds]   (default 2; ~2 min/seed
per variant on a quiet host)
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO / "src"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from bayesian_inference_tpu.io import observables as obs_io
from bayesian_inference_tpu.models import gp_fit, pca as pca_mod
from bayesian_inference_tpu.ops.gram import KernelConfig

DATA = REPO / "tests" / "test_data"
N_SEEDS = int(sys.argv[1]) if len(sys.argv) > 1 else 2
K_PC = 12
# Default was 21 for the round-5 single-rung study; the multi-rung study runs
# at the PRODUCTION restart count so absolute keep values transfer directly
# (keeping 16 of 52 is a different selection problem than 16 of 22).
N_RESTARTS = int(sys.argv[2]) if len(sys.argv) > 2 else 50

Y = obs_io.predictions_matrix_from_h5(str(DATA), "observables.h5")
X = np.asarray(obs_io.design_array_from_h5(str(DATA), "observables.h5"))
_, Y_pca = pca_mod.fit_pca(np.asarray(Y))
Y_pc = np.asarray(Y_pca)[:, :K_PC]

cfg = KernelConfig(nu=1.5, with_noise=True)
base_spec = gp_fit.spec_from_reference_config(
    cfg, param_min=X.min(axis=0), param_max=X.max(axis=0),
    n_restarts=N_RESTARTS, n_iters=60, alpha_jitter=1e-6,
)

# (label, overrides) — n_iters=total, halving at halving_iters, keep survivors.
# Round-5 phase 2 (multi-rung study, production R): the single-rung study
# (docs/fit_schedule_study.json, R=21) fixed keep=3 and found the 15-iter
# exploration resists iteration cuts when the rung prunes to the FINAL pool;
# these candidates instead insert a GENTLE early rung (keep 12-20 of 51 —
# basin diversity retained) so iters 7-15 run on a third of the batch.
VARIANTS = [
    ("base_h15_k3_i60", {}),
    ("mr_h8k16_h7k3", {"halving_schedule": ((8, 16), (7, 3))}),
    ("mr_h6k16_h9k3", {"halving_schedule": ((6, 16), (9, 3))}),
    ("mr_h5k12_h10k3", {"halving_schedule": ((5, 12), (10, 3))}),
    ("mr_h4k20_h6k8_h5k3", {"halving_schedule": ((4, 20), (6, 8), (5, 3))}),
]

# Production-batch relative cost (R=51, k=41, baseline schedule)
def prod_cost(halving_iters=15, halving_keep=3, n_iters=60, halving_schedule=(), **_):
    R, k = 51, 41
    schedule = tuple(halving_schedule) or ((halving_iters, halving_keep),)
    cost, pool, used = 0, R, 0
    for it, keep in schedule:
        cost += pool * it
        pool, used = keep, used + it
    return k * (cost + pool * (n_iters - used))

base_cost = prod_cost()

results = {}
base_lml = {}
for seed in range(N_SEEDS):
    for label, ov in VARIANTS:
        spec = base_spec.replace(**ov)
        posts = gp_fit.fit_gps(spec, jnp.asarray(X), jnp.asarray(Y_pc), jax.random.key(seed))
        lml = np.asarray(posts.lml)
        if label.startswith("base"):
            base_lml[seed] = lml
        d = lml - base_lml[seed]
        results.setdefault(label, []).append(d)
        print(f"# seed {seed} {label}: max|dLML|={np.abs(d).max():.4g} "
              f"min(dLML)={d.min():.4g}", file=sys.stderr)

report = {
    "shape": {"N": int(X.shape[0]), "ndim": int(X.shape[1]), "k_pc": K_PC,
              "n_restarts": N_RESTARTS, "seeds": N_SEEDS},
    "variants": {
        label: {
            "cost_vs_base": round(prod_cost(**{**dict(halving_iters=15, halving_keep=3, n_iters=60), **ov}) / base_cost, 3),
            "max_abs_dlml": round(float(np.abs(np.stack(results[label])).max()), 6),
            "min_dlml": round(float(np.stack(results[label]).min()), 6),
        }
        for label, ov in VARIANTS
    },
}
print(json.dumps(report, indent=1))
