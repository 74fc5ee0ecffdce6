"""Run the analysis once on one NVIDIA GPU and check what comes out.

    python chip_smoke.py

The quickest proof that the system runs on the card. One process, one card,
production widths: the synthetic production table set (144 observables,
1,644 features, the 230-point design with its 3 missing ids), the three
production emulation groups (5/11/25 PCs, 50 restarts), 100 walkers.

Phases; a failing phase ends the run with a non-zero exit code before the
last line is printed:

1. device: JAX's platform, device kind and count, the card's name and power
   limit, the compile-cache directory, which optional packages import.
   Exits unless JAX runs on a GPU.
2. kernels: the fused block-MVN Triton kernel (ops/pallas_mvn.py) compiled at
   every production bucket width, compared with a float64 host reference, and
   timed beside the plain XLA version at the same shapes.
3. main path: ``SteerAnalysis.run_analysis`` end to end (ingest -> fit ->
   block-mode MCMC), then a short lowrank ``run_mcmc`` on the same emulators.
   Each run: mcmc.h5 exists, chain and log-probs are finite, mean acceptance
   in ACCEPTANCE_BAND, and the final walkers' device log-posteriors agree
   with a float64 evaluation of the same fitted likelihood on the host.
4. measurements on the fitted likelihood: kernel vs plain XLA inside the
   jitted sampler step (alternating; 100 and 200 walkers, i.e. W = 50 and
   100 per half-ensemble), the matmul-precision study, and one GP
   fit objective value+grad, autodiff vs matmul implementation.

Every time is printed with the card's name and power limit beside it. The
last line of standard output is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

from bayesian_inference_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

CACHE_DIR = configure_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

SEED = 0
WORKDIR = REPO / "output" / "chip_smoke"
N_WALKERS = 100
N_BURN, N_STEPS = 500, 4000
LOWRANK_BURN, LOWRANK_STEPS = 200, 1000
N_RESTARTS = 50
# (padded width nb, observable count) of the production block buckets.
PRODUCTION_BUCKETS = ((8, 40), (16, 96), (24, 8))
K_TOTAL = 41
# Stretch-move acceptance of a healthy 6-D posterior.
ACCEPTANCE_BAND = (0.2, 0.8)
# Kernel vs float64 reference, per block log-likelihood: |diff| / max(1, |ref|).
KERNEL_RTOL = 1e-4
# Device (float32) log-posterior vs float64 host: |diff| <= ATOL + RTOL |ref|.
LOGP_RTOL, LOGP_ATOL = 1e-4, 0.1
PRECISIONS = ("tensorfloat32", "TF32_TF32_F32_X3", "float32")

CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(msg: str, seconds: float) -> None:
    log(f"{msg}: {seconds:.6f} s  [{CARD}]")


def _time_us(fn, *args, n: int = 100) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e6


def _alternate(fns: dict, *args, n: int = 100) -> dict[str, float]:
    """Time two functions in the order a, b, b, a; mean us per call of each."""
    (a, fa), (b, fb) = fns.items()
    ta1, tb1, tb2, ta2 = (_time_us(f, *args, n=n) for f in (fa, fb, fb, fa))
    return {a: (ta1 + ta2) / 2, b: (tb1 + tb2) / 2}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")
    log(f"ok: {msg}")


# --------------------------------------------------------------------------------------
def phase_device() -> dict:
    global CARD
    from bayesian_inference_tpu.utils.device import card_name_and_power_limit, require_gpu

    log("== phase 1: device")
    info = require_gpu()
    CARD = card_name_and_power_limit()
    log(f"jax {jax.__version__}: platform={info['platform']} device_kind={info['kind']} "
        f"count={info['count']}")
    log(f"card (name, power limit): {CARD}")
    log(f"compile cache: {CACHE_DIR}")
    for mod in ("flax", "attrs", "yaml", "h5py", "matplotlib"):
        try:
            importlib.import_module(mod)
            log(f"import {mod}: yes")
        except ImportError:
            log(f"import {mod}: no")
    log(f"default matmul precision: {jax.config.jax_default_matmul_precision}")
    return info


# --------------------------------------------------------------------------------------
def _f64_block_loglike(U, D, d0, z, v) -> np.ndarray:
    """(W, n_obs) per-block log-likelihoods in float64 numpy."""
    dY = d0[None] + np.einsum("bfk,wk->wbf", U, z)
    C = D[None] + np.einsum("bfk,wk,bgk->wbfg", U, v, U)
    L = np.linalg.cholesky(C)
    e = np.linalg.solve(L, dY[..., None])[..., 0]
    return -0.5 * np.sum(e * e, -1) - np.sum(np.log(np.diagonal(L, axis1=-2, axis2=-1)), -1)


def phase_kernels() -> None:
    from bayesian_inference_tpu.ops.pallas_mvn import (
        composed_block_mvn_loglike,
        fused_block_mvn_kernel,
        kernel_tile,
    )

    log("== phase 2: kernels (fused block-MVN, Triton; float32 FMA arithmetic, no tensor cores)")
    rng = np.random.default_rng(SEED)
    kernel = jax.jit(lambda *a: jnp.sum(fused_block_mvn_kernel(*a), axis=0))
    plain = jax.jit(composed_block_mvn_loglike)
    for W in (N_WALKERS // 2, N_WALKERS):
        for nb, n_obs in PRODUCTION_BUCKETS:
            U = rng.normal(size=(n_obs, nb, K_TOTAL)) / np.sqrt(K_TOTAL)
            A = rng.normal(size=(n_obs, nb, nb))
            D = A @ np.swapaxes(A, -1, -2) / nb + 0.5 * np.eye(nb)
            d0 = rng.normal(size=(n_obs, nb))
            z = rng.normal(size=(W, K_TOTAL))
            v = rng.uniform(0.01, 1.0, size=(W, K_TOTAL))
            ref = _f64_block_loglike(U, D, d0, z, v)
            args = [jnp.asarray(a, jnp.float32) for a in (U, D, d0, z, v)]
            t0 = time.perf_counter()
            out = np.asarray(fused_block_mvn_kernel(*args)).T
            compile_s = time.perf_counter() - t0
            err = float(np.max(np.abs(out - ref) / np.maximum(1.0, np.abs(ref))))
            check(np.all(np.isfinite(out)) and err <= KERNEL_RTOL,
                  f"kernel W={W} nb={nb} n_obs={n_obs} tile={kernel_tile(nb, W)}: "
                  f"max rel err vs f64 {err:.3e} <= {KERNEL_RTOL} (compile+run {compile_s:.1f} s)")
            plain_err = float(np.max(np.abs(np.asarray(plain(*args)) - ref.sum(1))
                                     / np.maximum(1.0, np.abs(ref.sum(1)))))
            t = _alternate({"kernel": kernel, "xla": plain}, *args)
            log(f"  bucket alone: kernel {t['kernel']:.1f} us, plain XLA {t['xla']:.1f} us "
                f"(plain XLA rel err vs f64 {plain_err:.3e})  [{CARD}]")


# --------------------------------------------------------------------------------------
def _write_lowrank_config(workdir: Path, block_run_dir: Path, table_dir: Path):
    """Config for a lowrank MCMC over the block run's fitted emulators."""
    import yaml

    from bench import PRODUCTION_GROUPS, make_config

    workdir.mkdir(parents=True)
    path, analysis_name, param, analysis_config, run_dir = make_config(
        workdir, PRODUCTION_GROUPS, str(table_dir), exclude=[17, 43],
        likelihood_mode="lowrank", n_walkers=N_WALKERS, n_burn=LOWRANK_BURN,
        n_steps=LOWRANK_STEPS, n_restarts=N_RESTARTS,
    )
    cfg = yaml.safe_load(path.read_text())
    cfg["initialize_observables"] = False
    cfg["fit_emulators"] = False
    path.write_text(yaml.safe_dump(cfg))
    for f in block_run_dir.iterdir():
        if f.name.startswith(("emulation", "observables")):
            shutil.copy(f, run_dir / f.name)
    return path, run_dir


def _likelihoods(config_path: Path, mode: str):
    """(float32 device likelihood, float64 host likelihood) of a fitted run."""
    from bayesian_inference_tpu.io import observables as obs_io
    from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig, load_yaml

    cfg = load_yaml(config_path)
    (analysis_name, analysis_config), = cfg["analyses"].items()
    param = analysis_config["parameterizations"][0]
    emu = EmulationConfig.from_config_file(
        analysis_name=analysis_name, parameterization=param,
        config_file=str(config_path), analysis_config=analysis_config,
    )
    spec = analysis_config["parameterization"][param]
    results = emu.read_all_emulator_groups()
    exp = obs_io.data_array_from_h5(emu.output_dir, "observables.h5",
                                    observable_filter=emu.observable_filter)
    kw = dict(theta_min=spec["min"], theta_max=spec["max"], mode=mode)
    like32 = build_likelihood(emu, results, exp, **kw)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        like64 = build_likelihood(emu, results, exp, dtype=jnp.dtype("float64"), **kw)
    return like32, like64, emu


@jax.jit
def _logpost(like, x):
    return like.log_posterior(x)


@jax.jit
def _gp_eval(like, x):
    return like.gp_eval(x)


def _f64_logpost(like64, x: np.ndarray) -> np.ndarray:
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(_logpost(like64, np.asarray(x, np.float64)))


def _check_run(run_dir: Path, config_path: Path, mode: str, n_steps: int):
    from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

    check((run_dir / "mcmc.h5").exists(), f"[{mode}] mcmc.h5 written")
    out = read_dict_from_h5(str(run_dir), "mcmc.h5", verbose=False)
    chain, logp = np.asarray(out["chain"]), np.asarray(out["log_prob"])
    check(chain.shape == (n_steps, N_WALKERS, 6) and logp.shape == (n_steps, N_WALKERS),
          f"[{mode}] chain {chain.shape}, log_prob {logp.shape}")
    check(bool(np.all(np.isfinite(chain)) and np.all(np.isfinite(logp))),
          f"[{mode}] chain and log-probs finite")
    acc = float(np.mean(out["acceptance_fraction"]))
    lo, hi = ACCEPTANCE_BAND
    check(lo <= acc <= hi, f"[{mode}] mean acceptance {acc:.4f} in [{lo}, {hi}]")

    like32, like64, emu = _likelihoods(config_path, mode)
    x = chain[-1]
    ref = _f64_logpost(like64, x)
    dev = np.asarray(_logpost(like32, jnp.asarray(x, jnp.float32)))
    for name, val in (("sampler's log_prob", logp[-1]), ("device re-evaluation", dev)):
        err = np.abs(val - ref)
        ok = bool(np.all(err <= LOGP_ATOL + LOGP_RTOL * np.abs(ref)))
        check(ok, f"[{mode}] final walkers, {name} vs float64 host: max |diff| "
                   f"{err.max():.4e} (|ref| up to {np.abs(ref).max():.1f}; "
                   f"tolerance {LOGP_ATOL} + {LOGP_RTOL} |ref|)")
    return like32, like64, emu, chain[-2:], ref


def phase_main_path() -> tuple:
    from bench import PRODUCTION_GROUPS, make_config
    from bayesian_inference_tpu.io.synthetic import make_production_tables
    from bayesian_inference_tpu.pipeline.steer import SteerAnalysis
    from bayesian_inference_tpu.utils.helpers import setup_logging

    log("== phase 3: main path (SteerAnalysis: ingest -> fit -> MCMC)")
    setup_logging()
    shutil.rmtree(WORKDIR, ignore_errors=True)
    table_dir = WORKDIR / "tables"
    make_production_tables(table_dir)
    (WORKDIR / "block").mkdir()
    config_path, analysis_name, param, _, run_dir = make_config(
        WORKDIR / "block", PRODUCTION_GROUPS, str(table_dir), exclude=[17, 43],
        n_walkers=N_WALKERS, n_burn=N_BURN, n_steps=N_STEPS, n_restarts=N_RESTARTS,
    )
    steer = SteerAnalysis(str(config_path))
    steer.run_analysis()
    tag = f"{analysis_name}/{param}"
    stages = steer.stage_seconds
    timings = next(iter(steer.mcmc_results.values()))["timings"]
    timed("[block] stage initialize", stages[f"initialize[{tag}]"])
    timed("[block] stage fit_emulators (incl. compile)", stages[f"fit_emulators[{tag}]"])
    timed("[block] stage mcmc (incl. compile)", stages[f"mcmc[{tag}]"])
    for k in ("burn", "production", "autocorr", "write"):
        timed(f"[block] mcmc {k}", timings[k])
    log(f"[block] production: {timings['production'] / N_STEPS * 1e6:.1f} us per sampler "
        f"step ({N_WALKERS} walkers, download included)  [{CARD}]")
    block = _check_run(run_dir, config_path, "block", N_STEPS)

    log("-- lowrank run_mcmc on the same fitted emulators")
    lr_config, lr_dir = _write_lowrank_config(WORKDIR / "lowrank", run_dir, table_dir)
    steer_lr = SteerAnalysis(str(lr_config))
    steer_lr.run_analysis()
    timings = next(iter(steer_lr.mcmc_results.values()))["timings"]
    timed("[lowrank] stage mcmc (incl. compile)", steer_lr.stage_seconds[f"mcmc[{tag}]"])
    for k in ("burn", "production", "write"):
        timed(f"[lowrank] mcmc {k}", timings[k])
    log(f"[lowrank] production: {timings['production'] / LOWRANK_STEPS * 1e6:.1f} us per "
        f"sampler step  [{CARD}]")
    lowrank = _check_run(lr_dir, lr_config, "lowrank", LOWRANK_STEPS)
    return block, lowrank


# --------------------------------------------------------------------------------------
@contextlib.contextmanager
def _plain_block_mvn():
    """Trace the block likelihood with the plain XLA path instead of the kernel."""
    from bayesian_inference_tpu.ops import pallas_mvn

    kernel = pallas_mvn.fused_block_mvn_loglike
    pallas_mvn.fused_block_mvn_loglike = pallas_mvn.composed_block_mvn_loglike
    try:
        yield
    finally:
        pallas_mvn.fused_block_mvn_loglike = kernel


def _sampler_chunk(like32, x: np.ndarray, n_steps: int, ctx=contextlib.nullcontext):
    """A compiled n_steps sampler chunk traced under ``ctx``; returns a
    no-argument callable that runs it."""
    from bayesian_inference_tpu.mcmc.stretch import init_state, run_chunk

    def logp(aux, y):
        return aux.log_posterior(y)

    with ctx():
        state = init_state(jax.random.key(SEED), logp, jnp.asarray(x, jnp.float32), aux=like32)
        compiled = jax.jit(
            lambda st, aux: run_chunk(st, logp, n_steps, store_chain=False, aux=aux)[1]
        ).lower(state, like32).compile()
    run = lambda: compiled(state, like32)  # noqa: E731
    run.compiled = compiled
    return run


def _sampler_step_ab(like32, x: np.ndarray, n_steps: int = 2000) -> None:
    runs = {"kernel": _sampler_chunk(like32, x, n_steps),
            "xla": _sampler_chunk(like32, x, n_steps, _plain_block_mvn)}
    log(f"sampler chunk ({n_steps} steps) memory_analysis: "
        f"{runs['kernel'].compiled.memory_analysis()}")
    t = _alternate(runs, n=3)
    for name in ("kernel", "xla"):
        log(f"sampler step, block likelihood via {name}: {t[name] / n_steps:.2f} us per step "
            f"({x.shape[0]} walkers, {n_steps}-step chunks, alternating)  [{CARD}]")


def _precision_study(like32, like64, x: np.ndarray, emu) -> None:
    from bayesian_inference_tpu.models import gp as gp_mod
    from bayesian_inference_tpu.ops.pallas_mvn import composed_block_mvn_loglike

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        x64 = np.asarray(x, np.float64)
        z64, v64 = (np.asarray(a) for a in _gp_eval(like64, x64))
        asm64 = sum(np.asarray(jax.jit(composed_block_mvn_loglike)(U, D, d0, z64, v64))
                    for U, D, d0 in zip(like64.U, like64.D, like64.d0))
        ref = np.asarray(_logpost(like64, x64))
    g64 = like64.groups[0]
    D2_64, y64, p64 = _lml_inputs(g64, cpu)
    with jax.enable_x64(True), jax.default_device(cpu):
        lml64, grad64 = jax.tree.map(np.asarray, _lml_value_grad(g64.cfg, p64, D2_64, y64, emu))
    z32, v32 = jnp.asarray(z64, jnp.float32), jnp.asarray(v64, jnp.float32)
    g32 = like32.groups[0]
    D2_32, y32, p32 = (jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float32), t)
                       for t in (D2_64, y64, p64))
    passing = []
    for prec in PRECISIONS:
        try:
            with jax.default_matmul_precision(prec):
                z, v = (np.asarray(a) for a in _gp_eval(like32, jnp.asarray(x, jnp.float32)))
                asm = sum(np.asarray(jax.jit(composed_block_mvn_loglike)(U, D, d0, z32, v32))
                          for U, D, d0 in zip(like32.U, like32.D, like32.d0))
                logp = np.asarray(_logpost(like32, jnp.asarray(x, jnp.float32)))
                lml, grad = _lml_value_grad(g32.cfg, p32, D2_32, y32, emu)
        except ValueError as e:  # an algorithm the backend does not offer
            log(f"precision {prec}: not accepted ({e})")
            continue
        # Gradient error relative to the whole gradient's scale (some leaves,
        # e.g. a fixed constant's, are identically zero).
        ga, gb = (np.concatenate([np.ravel(np.asarray(a)) for a in jax.tree.leaves(g)])
                  for g in (grad, grad64))
        gerr = float(np.max(np.abs(ga - gb)) / np.max(np.abs(gb)))
        lerr = np.abs(logp - ref)
        if np.all(lerr <= LOGP_ATOL + LOGP_RTOL * np.abs(ref)):
            passing.append(prec)
        log(f"precision {prec}: GP predict max|dz| {np.max(np.abs(z - z64)):.3e} "
            f"max|dv|/max(v) {np.max(np.abs(v - v64)) / np.max(v64):.3e}; "
            f"plain assembly loglike max|d| {np.max(np.abs(asm - asm64)):.3e}; "
            f"fit LML max|d| {np.max(np.abs(np.asarray(lml) - lml64)):.3e}, grad "
            f"max|d|/max|grad| {gerr:.3e}; log-posterior max|d| {lerr.max():.4e} "
            f"(within tolerance: {prec in passing})")
    return passing


def _precision_cost(like32, x: np.ndarray, passing: list[str], n_steps: int = 2000) -> None:
    """Sampler-step time under the two cheapest precisions that pass."""
    if len(passing) < 2:
        return
    runs = {p: _sampler_chunk(like32, x, n_steps, lambda p=p: jax.default_matmul_precision(p))
            for p in passing[:2]}
    t = _alternate(runs, n=3)
    for p, us in t.items():
        log(f"sampler step at matmul precision {p}: {us / n_steps:.2f} us per step "
            f"(alternating)  [{CARD}]")


def _lml_inputs(group, cpu):
    """Float64 host (D2, y, params) of a stacked fitted GP group; y = K alpha."""
    from bayesian_inference_tpu.ops.gram import pairwise_sqdiff, train_gram

    posts = group.posts
    with jax.enable_x64(True), jax.default_device(cpu):
        X = jnp.asarray(posts.X[0])
        jitter = 1e-6
        K = jax.vmap(lambda p: train_gram(group.cfg, p, X, jitter))(posts.params)
        y = jnp.einsum("knm,km->kn", K, jnp.asarray(posts.alpha))
        return pairwise_sqdiff(X), y, posts.params


def _lml_value_grad(cfg, params, D2, y, emu):
    from bayesian_inference_tpu.models.gp import log_marginal_likelihood_sqdiff

    def one(p, yy):
        return jax.value_and_grad(
            lambda q: log_marginal_likelihood_sqdiff(cfg, q, D2, yy, 1e-6)
        )(p)

    return jax.jit(jax.vmap(one))(params, y)


def _fit_ab(emu) -> None:
    """One fit-objective value+grad over all (PC, restart) instances."""
    from bayesian_inference_tpu.io import observables as obs_io
    from bayesian_inference_tpu.models import gp_fit
    from bayesian_inference_tpu.ops.gram import pairwise_sqdiff

    groups = list(emu.emulation_groups_config.values())
    X = np.asarray(obs_io.design_array_from_h5(groups[0].output_dir, filename="observables.h5"))
    N = X.shape[0]
    B = K_TOTAL * (N_RESTARTS + 1)
    rng = np.random.default_rng(SEED)
    D2 = pairwise_sqdiff(jnp.asarray(X, jnp.float32))
    Y = jnp.asarray(rng.normal(size=(B, N)), jnp.float32)
    fns = {}
    for impl in ("autodiff", "matmul"):
        spec = groups[0].fit_spec().replace(lml_impl=impl)
        spec = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), spec)
        P = spec.theta0.shape[0]
        U = jnp.asarray(rng.normal(size=(B, P)), jnp.float32)

        def obj(u, y, spec=spec):
            return gp_fit._neg_lml_u(u, spec, D2, y)

        fns[impl] = jax.jit(jax.vmap(jax.value_and_grad(obj)))
    t = _alternate(fns, U, Y, n=10)
    for impl in ("autodiff", "matmul"):
        log(f"GP fit objective value+grad, {impl}: {t[impl] / 1e3:.2f} ms "
            f"(B={B} instances, N={N})  [{CARD}]")


def phase_measure(block) -> None:
    log("== phase 4: measurements on the fitted likelihood")
    like32, like64, emu, last2, _ = block
    x = last2[-1]
    _sampler_step_ab(like32, x)
    # The 200-walker configuration: W = 100 per half-ensemble.
    _sampler_step_ab(like32, np.concatenate(last2))
    passing = _precision_study(like32, like64, x, emu)
    _precision_cost(like32, x, passing)
    _fit_ab(emu)


def main() -> None:
    info = phase_device()
    phase_kernels()
    block, _ = phase_main_path()
    phase_measure(block)
    log(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
