"""Posterior-parity report: device fp32 pipeline vs CPU float64 vs an
independent numpy stretch-move reference, on the real fixture.

Usage:
    python scripts/parity_check.py            # CPU f64 vs CPU f32 + numpy ref
    python scripts/parity_check.py --device  # on the default device (a GPU)

Produces KS statistics and quantile differences per parameter; this is the
statistical-parity evidence for the BASELINE.json north star ("posteriors
match CPU emcee within MC error" — emcee itself is unavailable here, so the
reference is a clean-room numpy implementation of the same published
algorithm, tests/reference_stretch.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", action="store_true",
                        help="run on the default jax device (else force CPU f64)")
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--burn", type=int, default=2000)
    parser.add_argument("--walkers", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed for init positions + both samplers' RNG streams")
    parser.add_argument("--mode", default="block", choices=["block", "lowrank"],
                        help="likelihood mode (lowrank = exact full covariance)")
    args = parser.parse_args()

    import jax

    if not args.device:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np
    from scipy.stats import ks_2samp

    from bayesian_inference_tpu import io
    from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu.mcmc.stats import integrated_time
    from bayesian_inference_tpu.mcmc.stretch import run_ensemble
    from bayesian_inference_tpu.models import emulator
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig, load_yaml
    from config_factory import make_analysis_yaml
    from reference_stretch import run_stretch_numpy

    tmp = Path(tempfile.mkdtemp())
    config_path, analysis_name, param = make_analysis_yaml(tmp, n_restarts=5)
    analysis_config = load_yaml(config_path)["analyses"][analysis_name]
    emu_config = EmulationConfig.from_config_file(
        analysis_name=analysis_name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    emulator.fit_emulators(emu_config)
    results = emu_config.read_all_emulator_groups()
    exp = io.data_array_from_h5(emu_config.output_dir, "observables.h5",
                                observable_filter=emu_config.observable_filter)
    pspec = analysis_config["parameterization"][param]
    like = build_likelihood(emu_config, results, exp,
                            theta_min=pspec["min"], theta_max=pspec["max"],
                            mode=args.mode)

    rng = np.random.default_rng(args.seed)
    x0 = rng.uniform(pspec["min"], pspec["max"], (args.walkers, len(pspec["min"])))
    x0 = 0.5 * (x0 + np.mean([pspec["min"], pspec["max"]], axis=0))

    print(f"# backend: {jax.default_backend()} dtype: {like.theta_min.dtype}", file=sys.stderr)
    out = run_ensemble(jax.random.key(args.seed + 1), like.log_posterior,
                       jnp.asarray(x0, like.theta_min.dtype), args.steps)
    chain = np.asarray(out["chain"])[args.burn:]
    acc = float(np.asarray(out["acceptance_fraction"]).mean())

    # The independent numpy reference evaluates the same likelihood on the CPU
    # backend (host-resident copy): no device round trip per step, and the
    # device comparison then spans sampler implementation AND backend/precision
    # (GPU f32 scan vs CPU numpy loop).
    np_dt = np.dtype(str(like.theta_min.dtype))
    if args.device:
        like_ref = jax.tree.map(lambda a: np.asarray(a), like)
        logp_jit = jax.jit(like_ref.log_posterior, backend="cpu")
        ref_logp = lambda x: np.asarray(logp_jit(np.asarray(x, np_dt)))
    else:
        logp_jit = jax.jit(like.log_posterior)
        ref_logp = lambda x: np.asarray(logp_jit(jnp.asarray(x, np_dt)))
    chain_np, _, acc_np = run_stretch_numpy(rng, ref_logp, x0, args.steps)
    chain_np = chain_np[args.burn:]

    s1 = chain.reshape(-1, chain.shape[-1])
    s2 = chain_np.reshape(-1, chain.shape[-1])
    tau = max(
        integrated_time(chain, quiet=True).max(),
        integrated_time(chain_np, quiet=True).max(),
    )
    # Thin along the STEP axis (axis 0 of the (steps, walkers, ndim) chain)
    # BEFORE flattening: rows of the flattened array are walker-major within a
    # step, so thinning the flattened array by tau only decorrelates by
    # tau/n_walkers steps. Each retained step slice contributes all walkers
    # (quasi-independent in a stretch-move ensemble, standard emcee practice).
    thin = max(1, int(np.ceil(tau)))
    s1_thin = chain[::thin].reshape(-1, chain.shape[-1])
    s2_thin = chain_np[::thin].reshape(-1, chain.shape[-1])
    width = np.asarray(pspec["max"]) - np.asarray(pspec["min"])

    report = {
        "backend": jax.default_backend(),
        "mode": args.mode,
        "seed": args.seed,
        "steps": args.steps,
        "acceptance_ours": round(acc, 4),
        "acceptance_numpy_ref": round(float(acc_np.mean()), 4),
        "tau_max": round(float(tau), 1),
        "per_parameter": [],
    }
    for d in range(s1.shape[1]):
        ks = ks_2samp(s1_thin[:, d], s2_thin[:, d])
        report["per_parameter"].append({
            "dim": d,
            "ks_stat": round(float(ks.statistic), 4),
            "ks_pvalue": round(float(ks.pvalue), 4),
            "n_eff": int(s1_thin.shape[0]),
            "median_diff_over_prior_width": round(
                float(abs(np.median(s1[:, d]) - np.median(s2[:, d])) / width[d]), 5
            ),
            "q16_diff_over_prior_width": round(
                float(abs(np.quantile(s1[:, d], 0.16) - np.quantile(s2[:, d], 0.16)) / width[d]), 5
            ),
            "q84_diff_over_prior_width": round(
                float(abs(np.quantile(s1[:, d], 0.84) - np.quantile(s2[:, d], 0.84)) / width[d]), 5
            ),
        })
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
