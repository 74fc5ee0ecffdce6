"""MCMC orchestration: burn-in with top-likelihood walker resampling, on-device
production run, artifact output (reference run_mcmc, mcmc.py:34-134).

The whole production chain is one lax.scan launch; the only host round trips
are at the two burn-in boundaries (matching the reference's resampling logic,
mcmc.py:93-103) and the final chain download.
"""

from __future__ import annotations

import logging
import pickle
import os
import time as _time
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from bayesian_inference_tpu.io import hdf5, observables as obs_io
from bayesian_inference_tpu.mcmc import stats
from bayesian_inference_tpu.mcmc.likelihood import build_likelihood
from bayesian_inference_tpu.mcmc.stretch import run_ensemble
from bayesian_inference_tpu.pipeline.configs import EmulationConfig, MCMCConfig

logger = logging.getLogger(__name__)


def _logp_with_d0(like, d0, x):
    """Module-level operand-style closure-batch posterior: both the likelihood
    state and the per-point residual offset are runtime operands, so the
    batched closure programs are value-independent (stable persistent-cache
    keys — same rationale as mcmc/programs.py)."""
    return like.log_posterior_with_d0(d0, x)


def resample_walkers_to_top_positions(
    chain: np.ndarray, log_prob: np.ndarray, n_walkers: int
) -> np.ndarray:
    """Reposition walkers at the top-likelihood unique points of a burn-in chain.

    Matches the reference (mcmc.py:99): flatten, unique log-prob values sorted
    ascending, take the positions of the last n_walkers.
    """
    flat_chain = chain.reshape(-1, chain.shape[-1])
    flat_logp = log_prob.reshape(-1)
    _, unique_idx = np.unique(flat_logp, return_index=True)
    return flat_chain[unique_idx[-n_walkers:]]


def run_mcmc(
    config: MCMCConfig,
    closure_index: int = -1,
    seed: int = 0,
    mode: str | None = None,
    dtype=None,
    checkpoint_every: int | None = None,
    mesh=None,
    programs=None,
) -> dict[str, Any]:
    """Run the full MCMC for one analysis; writes mcmc.h5 + sampler state pickle.

    ``checkpoint_every``: production-phase checkpoint cadence in steps. When
    set, a resumable snapshot (walker coords, RNG key, chain-so-far) is written
    to mcmc_checkpoint.pkl after each chunk, and an interrupted run restarts
    from the latest snapshot instead of from scratch — step-granular resume the
    reference lists as an open TODO (mcmc.py:69-70). Costs one device dispatch
    per chunk; leave None for the single-dispatch fast path.

    ``mesh``: a jax.sharding.Mesh to shard the per-walker likelihood batch
    across chips (parallel/mesh.py); None runs single-device.

    ``programs``: a prewarmed ``SamplerPrograms`` (mcmc/programs.py,
    typically from ``prewarm_sampler_programs`` started before the GP fit).
    None compiles the operand-style executables inline; a failed prewarm
    falls back to the closure-style jit path.
    """
    if mode is None:
        mode = getattr(config, "likelihood_mode", "block")
    param_spec = config.parameterization_spec()
    theta_min = np.asarray(param_spec["min"], float)
    theta_max = np.asarray(param_spec["max"], float)
    ndim = len(param_spec["names"])

    import time as _time

    _t = _time.perf_counter()
    emulation_config = EmulationConfig.from_config_file(
        analysis_name=config.analysis_name,
        parameterization=config.parameterization,
        analysis_config=config.analysis_config,
        config_file=config.config_file,
    )
    emulation_results = emulation_config.read_all_emulator_groups()
    logger.info(f"emulator artifacts loaded: {_time.perf_counter() - _t:.2f}s")

    # Honor observables_filename (jet_substructure.yaml:34) for the data vector
    # and closure pseudodata. The reference hardcodes 'observables.h5' here
    # (mcmc.py:67) even when the rest of the pipeline runs on the preprocessed
    # file — we fix that wart so a preprocessed run is preprocessed end-to-end,
    # falling back to the raw file when preprocessing was skipped.
    obs_filename = _existing_observables_file(config)
    experimental_results = obs_io.data_array_from_h5(
        config.output_dir,
        obs_filename,
        pseudodata_index=closure_index,
        observable_filter=emulation_config.observable_filter,
        rng=np.random.default_rng(seed + 12345) if closure_index >= 0 else None,
    )

    _t = _time.perf_counter()
    like = build_likelihood(
        emulation_config,
        emulation_results,
        experimental_results,
        theta_min=theta_min,
        theta_max=theta_max,
        mode=mode,
        dtype=dtype,
    )
    logger.info(f"likelihood build: {_time.perf_counter() - _t:.2f}s")
    dt = like.theta_min.dtype
    np_dt = np.dtype(str(dt))

    if mesh is not None:
        from bayesian_inference_tpu.parallel.mesh import make_sharded_log_prob

        # jit-closure fallback path (AOT compile failure); the AOT programs
        # below are lowered with the same walker sharding.
        log_prob_fn = make_sharded_log_prob(like.log_posterior, mesh)
        logger.info(f"walker batch sharded over {mesh.devices.size} devices")
    else:
        log_prob_fn = like.log_posterior

    # Operand-style AOT executables: value-independent programs (stable
    # persistent-cache keys across runs) — see mcmc/programs.py. A prewarmed
    # handle overlaps all compile/load with the GP fit. With a mesh, the
    # executables are lowered with the walker batch partitioned over it, so
    # multi-chip runs keep the same cached-program benefits.
    from bayesian_inference_tpu.mcmc.programs import (
        SamplerPrograms, chunk_sizes_for_config,
    )

    if programs is not None and (
        programs.n_walkers != config.n_walkers
        or programs.ndim != ndim
        or programs.mesh != mesh
    ):
        logger.warning("prewarmed sampler programs have mismatched shapes/mesh; recompiling")
        programs = None
    if programs is None and mode in ("block", "lowrank"):
        programs = SamplerPrograms(
            like, config.n_walkers, ndim,
            chunk_sizes_for_config(config, checkpoint_every),
            mesh=mesh,
        )
        programs.compile()
    if programs is not None and not programs.ok():
        programs = None  # jit-closure fallback

    key = jax.random.key(seed)
    key, k_init = jax.random.split(key)
    x0 = jax.random.uniform(
        k_init, (config.n_walkers, ndim), minval=like.theta_min, maxval=like.theta_max, dtype=dt
    )

    nburn0 = config.n_burn_steps // 2
    nburn1 = config.n_burn_steps - nburn0

    def _run_phase(k, x_start, n_steps):
        """init + one chunk: (chain, log_prob, final coords) on device."""
        if programs is not None:
            state = programs.init(k, like, x_start)
            state, ys = programs.chunk(state, like, n_steps)
            return {"chain": ys[0], "log_prob": ys[1], "coords": state.coords}
        return run_ensemble(k, log_prob_fn, x_start, n_steps)

    timings: dict[str, float] = {}

    # --- burn-in phase 1 -------------------------------------------------------
    logger.info(f"Burn-in phase 1: {config.n_walkers} walkers x {nburn0} steps")
    _t = _time.perf_counter()
    key, k1 = jax.random.split(key)
    out1 = _run_phase(k1, x0, nburn0)
    jax.block_until_ready(out1["coords"])
    timings["burn"] = _time.perf_counter() - _t
    logger.info(f"burn-1 dispatch+exec: {timings['burn']:.2f}s")

    # --- reposition walkers at top-likelihood points (host, reference parity) ---
    x_top = resample_walkers_to_top_positions(
        np.asarray(out1["chain"]), np.asarray(out1["log_prob"]), config.n_walkers
    )
    logger.info("Resampled walker positions; burn-in phase 2")

    _t = _time.perf_counter()
    key, k2 = jax.random.split(key)
    out2 = _run_phase(k2, jax.device_put(np.asarray(x_top, np_dt)), nburn1)
    jax.block_until_ready(out2["coords"])
    timings["burn"] += _time.perf_counter() - _t
    logger.info(f"burn-2 dispatch+exec: {_time.perf_counter() - _t:.2f}s")

    # --- production -------------------------------------------------------------
    # Single-dispatch scan by default; the per-step acceptance trace in the
    # scan output provides the reference's n_logging_steps cadence
    # (mcmc.py:187-204) without chunking. checkpoint_every (or
    # BIQ_DISPATCH_CHUNK) switches to chunked dispatch with streamed
    # downloads + resumable snapshots.
    logger.info(f"Production: {config.n_sampling_steps} steps")
    _t = _time.perf_counter()
    key, k3 = jax.random.split(key)
    out3 = _run_production(
        config, k3, log_prob_fn, out2["coords"],
        checkpoint_every=checkpoint_every,
        sizes=_production_sizes(config, checkpoint_every),
        programs=programs,
        like=like,
    )
    timings["production"] = _time.perf_counter() - _t
    logger.info(f"production exec+download: {timings['production']:.2f}s")

    chain = np.asarray(out3["chain"])
    log_prob = np.asarray(out3["log_prob"])
    acceptance_fraction = np.asarray(out3["acceptance_fraction"])
    af = acceptance_fraction
    logger.info(
        f"acceptance fraction: mean {af.mean():.3f}, std {af.std():.3f}, min {af.min():.3f}, max {af.max():.3f}"
    )

    output_dict: dict[str, Any] = {
        "chain": chain,
        "acceptance_fraction": acceptance_fraction,
        "log_prob": log_prob,
    }
    _t = _time.perf_counter()
    try:
        output_dict["autocorrelation_time"] = stats.integrated_time(
            chain, mean_power=out3.get("mean_power")
        )
    except stats.AutocorrError as e:
        output_dict["autocorrelation_time"] = None
        logger.info(f"Could not compute autocorrelation time: {e}")
    # Split-chain R-hat: convergence check complementary to tau (neither the
    # reference nor emcee reports it; values near 1 = converged halves).
    rhat = out3.get("split_rhat")
    if rhat is None:
        rhat = stats.split_rhat(chain)
    output_dict["split_rhat"] = rhat
    # Persist the on-device walker-averaged ACF spectrum (~1.6 MB): the
    # tau-vs-length convergence plot then needs one host inverse transform
    # instead of re-running every forward FFT pass (plots/mcmc.py).
    if out3.get("mean_power") is not None:
        power, nfft = out3["mean_power"]
        output_dict["mean_power"] = np.asarray(power)
        output_dict["mean_power_nfft"] = int(nfft)
    timings["autocorr"] = _time.perf_counter() - _t
    logger.info(
        f"autocorrelation estimate: {timings['autocorr']:.2f}s; "
        f"split-Rhat max {rhat.max():.4f}"
    )

    if closure_index >= 0:
        design_point = obs_io.design_array_from_h5(
            config.output_dir, obs_filename, validation_set=True
        )[closure_index]
        output_dict["design_point"] = design_point
        output_dict["experimental_pseudodata"] = experimental_results

    _t = _time.perf_counter()
    if out3.get("streamed"):
        # Chain + log_prob already streamed to mcmc.h5 during the chunked
        # download (write overlapped device execution); top up metadata only.
        meta = {k: v for k, v in output_dict.items() if k not in ("chain", "log_prob")}
        hdf5.write_dict_to_h5(meta, config.mcmc_output_dir, "mcmc.h5", verbose=True)
    else:
        hdf5.write_dict_to_h5(output_dict, config.mcmc_output_dir, "mcmc.h5", verbose=True)
    timings["write"] = _time.perf_counter() - _t

    # emcee-API-compatible archive (reference pickles the whole sampler,
    # mcmc.py:127-132; get_chain/get_log_prob here serve lazily from the
    # mcmc.h5 written above instead of duplicating the chain into the pickle).
    from bayesian_inference_tpu.mcmc.sampler_archive import EnsembleSamplerArchive

    archive = EnsembleSamplerArchive(
        final_coords=np.asarray(out3["coords"]),
        final_log_prob=np.asarray(out3["final_log_prob"]),
        acceptance_fraction=acceptance_fraction,
        autocorrelation_time=output_dict.get("autocorrelation_time"),
        seed=seed,
        mode=mode,
    )
    os.makedirs(config.mcmc_output_dir, exist_ok=True)
    archive.save(config.sampler_outputfile)

    # Per-phase wall-clock (burn / production / autocorr / write) for callers
    # that report perf breakdowns; added AFTER the h5 write so the mcmc.h5
    # schema stays reference-identical.
    output_dict["timings"] = timings
    output_dict["used_aot_programs"] = programs is not None
    return output_dict


def run_closure_batch(
    config: MCMCConfig,
    closure_indices: Sequence[int],
    seed: int = 0,
    dtype=None,
    dispatch_chunk: int | None = None,
    mesh=None,
    mode: str | None = None,
    checkpoint_every: int | None = None,
    return_chains: bool = True,
) -> dict[int, dict[str, Any]]:
    """Run ALL closure-test MCMCs in one batched on-chip program.

    The reference runs one full MCMC per validation point sequentially
    (steer_analysis.py:174-181). The only per-point difference in the
    likelihood is the pseudodata residual offset d0 (data_IO.py:365-372), so
    the P ensembles vmap over a d0 batch inside a single lax.scan — one
    compiled program, one dispatch per phase, instead of P full runs. Both
    likelihood modes batch: 'block' swaps the bucketed d0 tensors, 'lowrank'
    rebuilds the d0-dependent Woodbury pieces per point against the cached
    d0-independent factorization (ops/mvn.py::WoodburyNormal.with_d0).

    Per-point sampling semantics (key derivation seed+index, pseudodata RNG,
    two-phase burn-in with top-likelihood resampling) exactly mirror
    ``run_mcmc(config_i, closure_index=i, seed=seed+i)``, and the per-point
    ``closure/results/<i>/mcmc.h5`` artifacts are written unchanged.

    Memory: production chain slabs STREAM to each point's mcmc.h5 as they
    download (io/hdf5.py::append_time_series) — peak host memory is one
    dispatch chunk (~256 MB bound), not the P x n_steps x W x d full batch.
    The per-point autocorrelation runs as batched FFT passes over groups of
    points read back from disk under the same memory bound.

    ``checkpoint_every``: production checkpoint cadence in steps; a snapshot
    of the sampler state lands in closure/closure_checkpoint.pkl after each
    chunk and an interrupted batch resumes from it (chains already on disk
    are kept, trimmed to the snapshot step).

    ``mesh``: a jax.sharding.Mesh — validation points are data-parallel, so
    the P axis shards across chips (the batch pads to a multiple of the mesh
    size with duplicate points whose outputs are discarded); each chip runs
    its share of the vmapped ensembles with no collectives in the hot loop.

    ``return_chains=False`` drops "chain"/"log_prob" from the returned dicts
    (they are on disk) — pass this at production scale.
    """
    from bayesian_inference_tpu.mcmc.likelihood import (
        pad_residual_offsets, residual_offsets_flat,
    )
    from bayesian_inference_tpu.mcmc.stretch import init_state_batched, run_chunk_batched

    import time as _time

    if mode is None:
        mode = getattr(config, "likelihood_mode", "block")
    closure_indices = list(closure_indices)
    P = len(closure_indices)
    assert P >= 1
    # Pad to a mesh-size multiple with duplicates of the last point; the
    # padded rows' chains are computed but never written out.
    n_pad = 0
    if mesh is not None:
        n_dev = int(mesh.devices.size)
        n_pad = (-P) % n_dev
    param_spec = config.parameterization_spec()
    theta_min = np.asarray(param_spec["min"], float)
    theta_max = np.asarray(param_spec["max"], float)
    ndim = len(param_spec["names"])
    W = config.n_walkers

    emulation_config = EmulationConfig.from_config_file(
        analysis_name=config.analysis_name,
        parameterization=config.parameterization,
        analysis_config=config.analysis_config,
        config_file=config.config_file,
    )
    emulation_results = emulation_config.read_all_emulator_groups()
    obs_filename = _existing_observables_file(config)

    exp_real = obs_io.data_array_from_h5(
        config.output_dir, obs_filename,
        observable_filter=emulation_config.observable_filter,
    )
    like = build_likelihood(
        emulation_config, emulation_results, exp_real,
        theta_min=theta_min, theta_max=theta_max, mode=mode, dtype=dtype,
    )
    dt = like.theta_min.dtype

    # Per-point pseudodata (validation prediction + N(0, sigma_exp)) with the
    # same RNG stream the sequential runner uses for closure index i.
    pseudodata = [
        obs_io.data_array_from_h5(
            config.output_dir, obs_filename, pseudodata_index=i,
            observable_filter=emulation_config.observable_filter,
            rng=np.random.default_rng(seed + i + 12345),
        )
        for i in closure_indices
    ]
    y_batch = np.stack([p["y"] for p in pseudodata])
    if mode == "block":
        d0_np = pad_residual_offsets(emulation_config, emulation_results, y_batch)
    else:
        d0_np = residual_offsets_flat(emulation_config, emulation_results, y_batch)
    if n_pad:
        d0_np = jax.tree.map(
            lambda d: np.concatenate([d, np.repeat(d[-1:], n_pad, axis=0)], axis=0), d0_np
        )
    d0_batch = jax.tree.map(
        lambda d: jax.device_put(np.asarray(d, np.dtype(str(dt)))), d0_np
    )
    fn = _logp_with_d0

    from bayesian_inference_tpu.parallel.mesh import shard_leading_axis

    d0_batch = jax.tree.map(lambda a: shard_leading_axis(a, mesh), d0_batch)

    # Per-point output configs + streamed-artifact bookkeeping.
    cfgs = {
        i: MCMCConfig(
            analysis_name=config.analysis_name,
            parameterization=config.parameterization,
            analysis_config=config.analysis_config,
            config_file=config.config_file,
            closure_index=i,
        )
        for i in closure_indices
    }
    n_total = config.n_sampling_steps
    ckpt_path = os.path.join(config.output_dir, "closure", "closure_checkpoint.pkl")

    # Key derivation mirrors run_mcmc per point: key(seed+i) -> split chain.
    key_ids = [seed + i for i in closure_indices] + [seed + closure_indices[-1]] * n_pad
    seeds = jnp.asarray(key_ids)
    keys = jax.vmap(jax.random.key)(seeds)

    def _vsplit(keys):
        ks = jax.vmap(jax.random.split)(keys)
        return ks[:, 0], ks[:, 1]

    # --- resume? ---------------------------------------------------------------
    ckpt_header = {
        "version": 2, "n_total": n_total, "indices": closure_indices,
        "seed": seed, "n_walkers": W, "ndim": ndim, "n_pad": n_pad,
    }
    resume_records = None
    resume = None
    if checkpoint_every and os.path.exists(ckpt_path):
        resume_records = _read_closure_checkpoint(ckpt_path, ckpt_header)
        if resume_records is not None:
            resume = resume_records[-1]
            logger.info(
                f"Resuming batched closure from checkpoint at step {resume['steps_done']}"
            )

    nburn0 = config.n_burn_steps // 2
    nburn1 = config.n_burn_steps - nburn0

    logger.info(
        f"Batched closure MCMC ({mode}): {P} validation points x {W} walkers, "
        f"burn-in {nburn0}+{nburn1}, production {n_total}"
        + (f" (+{n_pad} pad points sharded over {mesh.devices.size} devices)" if mesh is not None else "")
    )

    steps_done = 0
    acc_offset = np.zeros((P + n_pad, W), np.int64)
    if resume is None:
        keys, k_init = _vsplit(keys)
        x0 = jax.vmap(
            lambda k: jax.random.uniform(
                k, (W, ndim), minval=like.theta_min, maxval=like.theta_max, dtype=dt
            )
        )(k_init)
        x0 = shard_leading_axis(x0, mesh)

        # --- burn-in phase 1 (one batched program) ------------------------------
        _t = _time.perf_counter()
        keys, k1 = _vsplit(keys)
        states = init_state_batched(k1, fn, x0, d0_batch, shared_aux=like)
        states, ys1 = run_chunk_batched(states, fn, d0_batch, nburn0, shared_aux=like)
        chain1 = np.asarray(ys1[0])   # (nburn0, P, W, d)
        logp1 = np.asarray(ys1[1])
        logger.info(f"closure burn-1 ({P}x{nburn0}): {_time.perf_counter() - _t:.2f}s")

        # --- per-point top-likelihood resampling (host, reference parity) -------
        x_top = np.stack([
            resample_walkers_to_top_positions(chain1[:, p], logp1[:, p], W)
            for p in range(P + n_pad)
        ])

        _t = _time.perf_counter()
        keys, k2 = _vsplit(keys)
        x_top_dev = shard_leading_axis(jax.device_put(np.asarray(x_top, np.dtype(str(dt)))), mesh)
        states = init_state_batched(k2, fn, x_top_dev, d0_batch, shared_aux=like)
        states, _ = run_chunk_batched(states, fn, d0_batch, nburn1, store_chain=False, shared_aux=like)
        jax.block_until_ready(states.coords)
        logger.info(f"closure burn-2 ({P}x{nburn1}): {_time.perf_counter() - _t:.2f}s")

        keys, k3 = _vsplit(keys)
        states = init_state_batched(k3, fn, states.coords, d0_batch, shared_aux=like)
        # fresh run: drop any stale streamed chains from an earlier attempt
        for i in closure_indices:
            p_h5 = os.path.join(cfgs[i].mcmc_output_dir, "mcmc.h5")
            if os.path.exists(p_h5):
                os.remove(p_h5)
    else:
        from bayesian_inference_tpu.mcmc.stretch import EnsembleState

        steps_done = resume["steps_done"]
        acc_offset = resume["n_accepted"]
        # Rebuild the sampler state EXACTLY as checkpointed — including the
        # carried log_prob: re-evaluating it via init would pick up 1-ulp
        # fusion differences between the init program and the scan body,
        # breaking bit-exact resume of the stored log_prob trace.
        states = EnsembleState(
            coords=shard_leading_axis(
                jax.device_put(np.asarray(resume["coords"], np.dtype(str(dt)))), mesh
            ),
            log_prob=shard_leading_axis(
                jax.device_put(np.asarray(resume["log_prob"], np.dtype(str(dt)))), mesh
            ),
            n_accepted=shard_leading_axis(
                jax.device_put(np.zeros((P + n_pad, W), np.int32)), mesh
            ),
            key=jax.random.wrap_key_data(jnp.asarray(resume["key_data"])),
        )
        # trim streamed chains to the checkpoint step (a slab written after
        # the last durable record is re-generated). A chain SHORTER than the
        # checkpoint means a torn/deleted per-point artifact: resuming
        # would leave a gap in the chain, so refuse (the single-run path
        # raises for the same inconsistency).
        for i in closure_indices:
            n_have = hdf5.time_series_length(cfgs[i].mcmc_output_dir, "mcmc.h5", "chain")
            if n_have < steps_done:
                raise RuntimeError(
                    f"closure checkpoint at step {steps_done} but point {i}'s "
                    f"streamed chain has only {n_have} steps — artifacts are "
                    "inconsistent; delete closure/closure_checkpoint.pkl to restart"
                )
            if n_have > steps_done:
                hdf5.append_time_series(
                    cfgs[i].mcmc_output_dir, "mcmc.h5",
                    {"chain": np.empty((0, W, ndim), np.dtype(str(dt))),
                     "log_prob": np.empty((0, W), np.dtype(str(dt)))},
                    truncate_to=steps_done,
                )

    # --- production: chunked dispatch; slabs stream to per-point h5 -----------
    _t = _time.perf_counter()
    if dispatch_chunk is None:
        dispatch_chunk = _production_chunk(config, checkpoint_every)
        if dispatch_chunk is None:
            # Bound each downloaded (chain, logp) slab to ~256 MB: the P-way
            # batch multiplies the per-step payload, so a single-dispatch
            # download would be P x larger than a plain run's.
            per_step_bytes = P * W * (ndim + 1) * 4
            chunk = (256 << 20) // max(per_step_bytes, 1)
            dispatch_chunk = chunk if 0 < chunk < n_total else None
    remaining = n_total - steps_done
    sizes = (
        [dispatch_chunk] * (remaining // dispatch_chunk)
        + ([remaining % dispatch_chunk] if remaining % dispatch_chunk else [])
        if dispatch_chunk else [remaining]
    )
    ckpt_file = None
    if checkpoint_every:
        os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
        if resume_records is not None:
            # Rewrite header + the complete records just resumed from, then
            # append. Truncating to a bare header here would leave a crash
            # before the first new record with NO resumable state — the next run would restart from zero
            # and delete every point's streamed chain.
            with open(ckpt_path, "wb") as f:
                pickle.dump(ckpt_header, f)
                for r in resume_records:
                    pickle.dump(r, f)
            ckpt_file = open(ckpt_path, "ab")
        else:
            ckpt_file = open(ckpt_path, "wb")
            pickle.dump(ckpt_header, ckpt_file)
    quant = _ChainQuantizer.from_config(config, like)
    if quant is not None:
        # device idle here (burn-in downloaded / resume state uploaded):
        # safe window for the quantize program's first-exec compile.
        quant.prewarm([(n, P + n_pad, W, ndim) for n in sorted(set(sizes))])
    # HBM guard: the P-way batch multiplies every chunk slab, so dispatching
    # all chunks up front pins sum(sizes) x (P+pad) x W x (ndim+1) bytes of
    # chain+logp on device (~4.2 GB at 30 points x 50k x 100 walkers f32 —
    # and 2x that with 200 walkers). Within budget, dispatch-all is kept (the
    # live slabs also feed the on-device tau/R-hat pass below); above it, a
    # bounded window dispatches chunk k+w only after chunk k's slab is
    # written out and its device handle dropped, so P x walkers can grow past
    # HBM at the cost of the host-side autocorrelation fallback. The 8 GB
    # default is not yet calibrated on the H100 (80 GB).
    itemsize = np.dtype(str(dt)).itemsize
    slab_bytes = {n: n * (P + n_pad) * W * (ndim + 1) * itemsize for n in set(sizes)}
    hbm_budget = int(os.environ.get("BIQ_CLOSURE_HBM_BUDGET_MB", "8192")) << 20
    window = len(sizes)
    if sum(slab_bytes[n] for n in sizes) > hbm_budget:
        window = int(max(2, hbm_budget // max(max(slab_bytes.values()), 1)))
        logger.info(
            f"closure dispatch window: {window} chunks in flight "
            f"(full batch {sum(slab_bytes[n] for n in sizes) >> 20} MB > "
            f"budget {hbm_budget >> 20} MB; BIQ_CLOSURE_HBM_BUDGET_MB tunes)"
        )
    keep_slabs = window >= len(sizes)

    pending: list = []  # dispatched, not-yet-written chunks (slabs kept if keep_slabs)
    i_next = 0

    def _dispatch_upto(limit: int) -> None:
        nonlocal states, i_next
        while i_next < min(limit, len(sizes)):
            n_i = sizes[i_next]
            states, ys_i = run_chunk_batched(states, fn, d0_batch, n_i, shared_aux=like)
            qc_i = quant.quantize(ys_i[0]) if quant is not None else None
            ql_i = quant.quantize_logp(ys_i[1]) if quant is not None else None
            pending.append((n_i, ys_i, qc_i, ql_i, states))
            i_next += 1

    _dispatch_upto(window)
    # Fault-injection hook: abort after N chunk downloads (exercises the
    # checkpoint/resume path in tests without killing the process).
    abort_after = int(os.environ.get("BIQ_CLOSURE_ABORT_AFTER_CHUNKS", "0") or 0)
    # Download in dispatch order; each slab is written to the per-point files
    # and dropped before the next-but-one download (bounded host memory: at
    # most two chunks in flight). A 2-worker pool fetches chunk k+1 while
    # chunk k's slab is being appended to the P per-point files, so host
    # writes overlap the next transfer.
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=2)
    inflight = {}

    def _prefetch(i_chunk):
        if 0 <= i_chunk < len(pending) and i_chunk not in inflight:
            _n, ys_i, qc_i, ql_i, _s = pending[i_chunk]
            inflight[i_chunk] = (
                pool.submit(_fetch, ys_i[0] if qc_i is None else qc_i),
                pool.submit(_fetch, ys_i[1] if ql_i is None else ql_i),
            )

    _prefetch(0)
    hedge = _HedgedFetcher()
    t_prev_arr = _time.perf_counter()
    for i_chunk in range(len(sizes)):
        _dispatch_upto(i_chunk + window)  # keep the in-flight window full
        _prefetch(i_chunk)
        _prefetch(i_chunk + 1)
        n, ys, qc, ql, snap = pending[i_chunk]
        f_chain, f_logp = inflight.pop(i_chunk)
        nb_chain = _nbytes(ys[0] if qc is None else qc)
        nb_logp = _nbytes(ys[1] if ql is None else ql)
        fired0 = hedge.fired
        raw = hedge.result(
            f_chain, ys[0] if qc is None else qc, "closure chain slab",
            nbytes=nb_chain,
        )  # (n, P+pad, W, d)
        chain_slab = raw if quant is None else quant.dequantize(raw)
        raw_lp = hedge.result(
            f_logp, ys[1] if ql is None else ql, "closure log-prob slab",
            nbytes=nb_logp,
        )
        logp_slab = raw_lp if quant is None else quant.dequantize_logp(raw_lp)
        t_arr = _time.perf_counter()
        if hedge.fired == fired0:
            hedge.observe(nb_chain + nb_logp, t_arr - t_prev_arr)
        t_prev_arr = t_arr
        if not keep_slabs:
            # drop the device handles: the backend frees the chunk's HBM and
            # the window admits the next dispatch
            pending[i_chunk] = (n, None, None, None, None)
            del ys, qc, ql, raw
        for p, i in enumerate(closure_indices):
            hdf5.append_time_series(
                cfgs[i].mcmc_output_dir, "mcmc.h5",
                {"chain": chain_slab[:, p], "log_prob": logp_slab[:, p]},
            )
        steps_done += n
        if ckpt_file is not None:
            pickle.dump({
                "steps_done": steps_done,
                "n_accepted": acc_offset + np.asarray(snap.n_accepted, np.int64),
                "coords": np.asarray(snap.coords),
                "log_prob": np.asarray(snap.log_prob),
                "key_data": np.asarray(jax.random.key_data(snap.key)),
            }, ckpt_file)
            ckpt_file.flush()
            if abort_after and i_chunk + 1 >= abort_after:
                ckpt_file.close()
                pool.shutdown(wait=False)
                raise RuntimeError(
                    "closure batch aborted by BIQ_CLOSURE_ABORT_AFTER_CHUNKS (test hook)"
                )
    pool.shutdown()
    hedge.shutdown()
    if ckpt_file is not None:
        ckpt_file.close()
        os.remove(ckpt_path)

    # Accelerator-side per-point tau spectra + R-hat: the device chain slabs
    # are still alive in ``pending`` and the device is idle (all chunks
    # downloaded), so each point's full chain is assembled and transformed
    # on the device one point at a time (bounded device memory) and only the tiny
    # spectra download — the host FFT passes disappear entirely. Fresh runs
    # only: a resumed prefix lives in the per-point h5 files (host fallback).
    device_stats = None  # (power (P,K,d), nfft, rhat (P,d)) when on-accelerator
    if sum(sizes) == n_total and keep_slabs:  # fresh run: every slab on device
        probe = next((ys[0] for _, ys, _qc, _ql, _ in pending if hasattr(ys[0], "devices")), None)
        if (
            probe is not None
            and next(iter(probe.devices())).platform != "cpu"
            and os.environ.get("BIQ_DEVICE_ACF", "1").lower() not in ("0", "false")
        ):
            device_stats = stats.device_closure_stats([ys[0] for _, ys, _qc, _ql, _ in pending])

    acceptance = (acc_offset + np.asarray(states.n_accepted, np.int64)).astype(float) / n_total
    logger.info(
        f"closure production ({P}x{remaining}): {_time.perf_counter() - _t:.2f}s "
        f"({P * remaining / max(_time.perf_counter() - _t, 1e-9):.0f} point-steps/s), "
        f"mean acceptance {acceptance.mean():.3f}"
    )

    # --- per-point statistics + metadata (artifact format == sequential runner) -
    design_val = obs_io.design_array_from_h5(
        config.output_dir, obs_filename, validation_set=True
    )
    outputs: dict[int, dict[str, Any]] = {}
    # Batched autocorrelation: groups of points bounded by a host-memory
    # budget, ONE FFT pass per group (vs the reference's / the sequential
    # runner's per-point estimator calls).
    budget = int(os.environ.get("BIQ_CLOSURE_STATS_BUDGET_MB", "512")) << 20
    bytes_per_point = n_total * W * (ndim + 1) * 8
    group_size = max(1, min(P, budget // max(bytes_per_point, 1)))

    for g0 in range(0, P, group_size):
        grp = closure_indices[g0 : g0 + group_size]
        chains, logps = [], []
        if return_chains or device_stats is None:
            # host path (and/or caller wants chains back): re-read the
            # streamed per-point artifacts group by group (bounded memory)
            for i in grp:
                ds = hdf5.read_datasets(cfgs[i].mcmc_output_dir, "mcmc.h5", ["chain", "log_prob"])
                chains.append(ds["chain"])
                logps.append(ds["log_prob"] if return_chains else None)
        if device_stats is None:
            chain_g = np.stack(chains, axis=1)   # (n_t, G, W, d)
            tau_g, reliable_g = stats.integrated_time_batched(chain_g)
        for gi, i in enumerate(grp):
            out_p: dict[str, Any] = {
                "acceptance_fraction": acceptance[g0 + gi],
                "design_point": design_val[i],
                "experimental_pseudodata": pseudodata[g0 + gi],
            }
            if device_stats is not None:
                powers, nfft, rhats = device_stats
                tau_p, rel_p = stats.integrated_time_from_power(
                    powers[g0 + gi], nfft, n_total, out_dtype=np.dtype(str(dt))
                )
                tau_i, reliable_i = tau_p, bool(rel_p.all())
                out_p["split_rhat"] = rhats[g0 + gi]
            else:
                tau_i, reliable_i = tau_g[gi], bool(reliable_g[gi].all())
                out_p["split_rhat"] = stats.split_rhat(chains[gi])
            if reliable_i:
                out_p["autocorrelation_time"] = tau_i
            else:
                out_p["autocorrelation_time"] = None
                logger.info(f"closure point {i}: chain shorter than 50 tau; no estimate")
            hdf5.write_dict_to_h5(out_p, cfgs[i].mcmc_output_dir, "mcmc.h5", verbose=False)
            if return_chains:
                out_p["chain"] = chains[gi]
                out_p["log_prob"] = logps[gi]
            outputs[i] = out_p
    return outputs


def _read_closure_checkpoint(
    path: str, expected_header: dict[str, Any]
) -> list[dict[str, Any]] | None:
    """Complete records of a batched-closure checkpoint stream (oldest first),
    or None when the header doesn't match this run. The header pins everything
    that determines the snapshot array shapes and the RNG stream — points,
    seed, chain length, walker count, ndim, and the mesh pad width — so a
    checkpoint written under a different mesh (different n_pad) is rejected
    with a clear message instead of failing with a broadcast error deep in
    the vmapped sampler."""
    records: list[dict[str, Any]] = []
    with open(path, "rb") as f:
        try:
            header = pickle.load(f)
            for k, v in expected_header.items():
                if header.get(k) != v:
                    logger.warning(
                        f"closure checkpoint incompatible ({k}: "
                        f"{header.get(k)!r} != {v!r}); restarting fresh"
                    )
                    return None
            while True:
                records.append(pickle.load(f))
        except (EOFError, pickle.UnpicklingError):
            pass
    if not records or records[-1]["steps_done"] >= expected_header["n_total"]:
        return None
    return records


def _existing_observables_file(config) -> str:
    """The configured observables file, or 'observables.h5' if the configured
    (e.g. preprocessed) file was never produced."""
    name = getattr(config, "observables_filename", "observables.h5")
    if name != "observables.h5" and not os.path.exists(
        os.path.join(config.output_dir, name)
    ):
        logger.warning(f"{name} not found in {config.output_dir}; using observables.h5")
        return "observables.h5"
    return name


def _checkpoint_path(config: MCMCConfig) -> str:
    return os.path.join(config.mcmc_output_dir, "mcmc_checkpoint.pkl")


def _device_chain_stats(pieces) -> dict[str, Any]:
    """Accelerator-side post-production diagnostics inputs.

    The tau power spectrum and split-R-hat run on the accelerator instead of
    as host FFT passes over the downloaded chain. Returns {} for chains on
    the CPU backend (the CPU test suite keeps the host-side reference
    implementations) or when ``BIQ_DEVICE_ACF=0``; callers fall back to the
    host path on {}.

    Called once the device is idle (all production chunks downloaded).
    """
    if os.environ.get("BIQ_DEVICE_ACF", "1").lower() in ("0", "false"):
        return {}
    dev_arr = next((p for p in pieces if hasattr(p, "devices")), None)
    if dev_arr is None:
        return {}
    if next(iter(dev_arr.devices())).platform == "cpu":
        return {}
    _t = _time.perf_counter()
    # Concatenate/upload ONCE: on a resumed run pieces[0] is a host-resident
    # chain prefix that would otherwise be uploaded twice (each stats
    # helper does its own concatenate of whatever list it is handed).
    if isinstance(pieces, (list, tuple)) and len(pieces) > 1:
        pieces = [jnp.concatenate([jnp.asarray(p) for p in pieces], axis=0)]
    out = {
        "mean_power": stats.device_mean_power(pieces),
        "split_rhat": stats.device_split_rhat(pieces),
    }
    logger.info(f"device chain stats (power spectrum + R-hat): {_time.perf_counter() - _t:.2f}s")
    return out


@jax.jit
def _quantize_box_u16(x, tmin, scale):
    q = jnp.rint((x - tmin) * scale)
    return jnp.clip(q, 0.0, 65535.0).astype(jnp.uint16)


@jax.jit
def _quantize_minmax_u16(x):
    """Quantize against the batch's own finite min/span (for log_prob slabs,
    which have no a-priori box). Codes 0..65534 span [lo, lo+span]; code 65535
    is the non-finite sentinel (a walker pinned at the prior boundary carries
    log_prob = -inf). Returns (codes, lo, span) — lo/span download as scalars."""
    finite = jnp.isfinite(x)
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    lo = jnp.min(jnp.where(finite, x, big))
    hi = jnp.max(jnp.where(finite, x, -big))
    span = jnp.maximum(hi - lo, jnp.asarray(jnp.finfo(x.dtype).tiny, x.dtype))
    q = jnp.clip(jnp.rint((x - lo) * (65534.0 / span)), 0.0, 65534.0).astype(jnp.uint16)
    return jnp.where(finite, q, jnp.asarray(65535, jnp.uint16)), lo, span


class _ChainQuantizer:
    """Opt-in uint16 chain + log-prob transfer (config ``chain_transfer:
    uint16`` / ``BIQ_CHAIN_TRANSFER=uint16``).

    Walker coordinates always lie inside the prior box (out-of-box proposals
    get -inf and are rejected), so they quantize losslessly-in-structure to
    uint16 in prior-box units: q = rint((x - min) * 65535 / range), computed
    ON DEVICE so the d2h transfer — the bench's dominant phase — carries half
    the bytes. The log-prob trace quantizes against its own per-chunk finite
    min/span (absolute error <= span/131068, with a sentinel code for -inf);
    at production scale that is another 10 MB off the download. Host-side
    dequantization back to the archive dtype happens before anything is
    written to mcmc.h5 (the artifact schema is unchanged); docs/PARITY.md
    records the resulting posterior-quantile/tau deltas (« the chains' own MC
    error). The default transfer remains lossless.

    ``prewarm`` executes the quantize programs on zeros of each chunk shape
    BEFORE production chunks dispatch, so no compilation lands between
    production chunks.
    """

    MODES = ("uint16",)

    def __init__(self, theta_min, theta_max, dt):
        self.np_dt = np.dtype(str(dt))
        self.tmin = np.asarray(theta_min, np.float64)
        self.tmax = np.asarray(theta_max, np.float64)
        # host-cast then device_put (CLAUDE.md: on-device casts compile)
        self._tmin_dev = jax.device_put(np.asarray(self.tmin, self.np_dt))
        self._scale_dev = jax.device_put(
            np.asarray(65535.0 / (self.tmax - self.tmin), self.np_dt)
        )

    @classmethod
    def from_config(cls, config, like) -> "_ChainQuantizer | None":
        mode = getattr(config, "chain_transfer", "") or ""
        if not mode:
            return None
        if mode not in cls.MODES:
            logger.warning(f"unknown chain_transfer {mode!r}; using lossless transfer")
            return None
        if like is None:
            logger.warning("chain_transfer needs the likelihood operand; using lossless")
            return None
        return cls(np.asarray(like.theta_min), np.asarray(like.theta_max), like.theta_min.dtype)

    def quantize(self, chain):
        return _quantize_box_u16(chain, self._tmin_dev, self._scale_dev)

    def quantize_logp(self, logp):
        """(codes, lo, span) device tuple for a log-prob slab."""
        return _quantize_minmax_u16(logp)

    #: (shape, dtype) pairs whose quantize programs were already first-executed
    #: in this process — the server-side program survives, so re-warming each
    #: run would only re-download dummy codes (~0.5 s/run at production scale).
    _warmed: set = set()

    def prewarm(self, shapes) -> None:
        for shape in shapes:
            key = (tuple(shape), str(self.np_dt))
            if key in _ChainQuantizer._warmed:
                continue
            np.asarray(self.quantize(jnp.zeros(shape, self.np_dt)))
            _fetch(self.quantize_logp(jnp.zeros(shape[:-1], self.np_dt)))
            _ChainQuantizer._warmed.add(key)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        x = self.tmin + np.asarray(q, np.float64) * ((self.tmax - self.tmin) / 65535.0)
        return x.astype(self.np_dt)

    def dequantize_logp(self, fetched) -> np.ndarray:
        q, lo, span = (np.asarray(a) for a in fetched)
        x = np.float64(lo) + q.astype(np.float64) * (np.float64(span) / 65534.0)
        return np.where(q == 65535, -np.inf, x).astype(self.np_dt)


def _fetch(buf):
    """Device->host transfer of one buffer or a tuple of buffers (each
    np.asarray issues its own d2h RPC; a tuple rides one pool task)."""
    if isinstance(buf, tuple):
        return tuple(np.asarray(b) for b in buf)
    return np.asarray(buf)


#: process-wide count of hedge fires (stalled/failed primaries raced) —
#: telemetry for the bench JSON; the per-run count is _HedgedFetcher.fired.
HEDGES_FIRED_TOTAL = 0


def _nbytes(buf) -> int:
    """Transfer size of a device buffer (or tuple of buffers) in bytes."""
    try:
        if isinstance(buf, tuple):
            return sum(_nbytes(b) for b in buf)
        return int(buf.size) * int(np.dtype(buf.dtype).itemsize)
    except Exception:
        return 0


class _HedgedFetcher:
    """Tail-latency hedge for device->host transfers.

    Guards against an individual device->host transfer that stalls while
    others complete. When a pending transfer exceeds the hedge deadline, race
    a SECOND independent
    transfer of the same buffer from a fresh thread and take whichever
    finishes first: jax.Array._value has no cross-thread dedup — each
    np.asarray call issues its own device->host copy — so the hedge follows
    a fresh RPC path. During genuinely slow (not stalled) windows the hedge
    duplicates at most one in-flight chunk (~25% extra bytes, bounded);
    BIQ_FETCH_HEDGE_S tunes the deadline (0 disables).

    The flat deadline is also a SIZE-AWARE adaptive one: the consumer feeds
    completed chunk arrivals to ``observe(nbytes, seconds)`` and passes each
    fetch's byte count to ``result(..., nbytes=)``; once a link rate is
    learned, a pending transfer hedges after
    ``BIQ_FETCH_HEDGE_FACTOR x expected_time`` (clamped to
    [BIQ_FETCH_HEDGE_MIN_S, BIQ_FETCH_HEDGE_S]) instead of the flat cap,
    so a stalled transfer is raced long before the 45 s flat deadline.
    Arrival intervals that include device-execution wait
    only UNDER-estimate the rate, which lengthens deadlines (conservative);
    chunks rescued by a fired hedge are not fed back (a stall would poison
    the rate estimate). BIQ_FETCH_HEDGE_MIN_S=45 (= the cap) effectively
    reverts to the flat behavior.
    """

    def __init__(self, hedge_s: float | None = None, deadline_s: float | None = None):
        if hedge_s is None:
            hedge_s = float(os.environ.get("BIQ_FETCH_HEDGE_S", "45"))
        if deadline_s is None:
            deadline_s = float(os.environ.get("BIQ_FETCH_DEADLINE_S", "0") or 0)
            if deadline_s <= 0:
                # Escalation deadline: if BOTH the primary and the hedge hang
                # (the device connection itself is gone), give up and
                # raise instead of looping forever — the streamed mcmc.h5 +
                # checkpoint make the run resumable, a silent hang does not.
                deadline_s = max(20.0 * hedge_s, 600.0)
        self.hedge_s = hedge_s
        self.deadline_s = deadline_s
        self.min_s = float(os.environ.get("BIQ_FETCH_HEDGE_MIN_S", "5"))
        self.factor = float(os.environ.get("BIQ_FETCH_HEDGE_FACTOR", "4"))
        self.fired = 0  # hedges fired (consumers use it to gate observe())
        self._rate_Bps: float | None = None
        self._pool = None

    def observe(self, nbytes: int, seconds: float) -> None:
        """Feed one completed transfer's size and arrival interval (EWMA)."""
        if nbytes <= 0 or seconds <= 1e-3:
            return
        rate = nbytes / seconds
        self._rate_Bps = (
            rate if self._rate_Bps is None else 0.5 * self._rate_Bps + 0.5 * rate
        )

    def deadline_for(self, nbytes: int | None) -> float:
        """Hedge deadline for a transfer of ``nbytes`` (flat cap until a
        link rate has been observed)."""
        if self.hedge_s <= 0 or not nbytes or self._rate_Bps is None:
            return self.hedge_s
        expected = nbytes / self._rate_Bps
        return min(self.hedge_s, max(self.min_s, self.factor * expected + 1.0))

    def result(self, fut, buf, label: str, nbytes: int | None = None):
        import concurrent.futures as cf
        import time as _t

        global HEDGES_FIRED_TOTAL
        if self.hedge_s <= 0:
            return fut.result()
        t0 = _t.monotonic()
        t_hedge = self.deadline_for(nbytes)
        pending = set()
        try:
            return fut.result(timeout=t_hedge)
        except cf.TimeoutError:
            pending.add(fut)
            self.fired += 1
            HEDGES_FIRED_TOTAL += 1
            logger.warning(
                f"{label} transfer stalled for {t_hedge:.0f}s; racing a second transfer"
            )
        except Exception as e:
            # A transfer error on the primary is the same flake the hedge
            # exists for — retry once from a fresh thread before giving up.
            self.fired += 1  # not a clean rate sample either
            HEDGES_FIRED_TOTAL += 1
            logger.warning(
                f"{label} transfer failed ({type(e).__name__}); retrying from a fresh thread"
            )
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=2)
        pending.add(self._pool.submit(_fetch, buf))
        while True:
            remaining = self.deadline_s - (_t.monotonic() - t0)
            if remaining <= 0:
                raise TimeoutError(
                    f"{label}: transfer still pending after "
                    f"{_t.monotonic() - t0:.0f}s (both the primary and the "
                    f"hedged RPC hung; deadline BIQ_FETCH_DEADLINE_S="
                    f"{self.deadline_s:.0f}s). The streamed mcmc.h5 and "
                    "checkpoint are intact — rerun to resume from the last "
                    "complete chunk."
                )
            done, pending = cf.wait(
                pending,
                timeout=min(max(60.0, self.hedge_s), remaining),
                return_when=cf.FIRST_COMPLETED,
            )
            for f in done:
                if f.exception() is None:
                    return f.result()
            if done:
                # the completed racer failed; re-raise only once nothing is left
                if not pending:
                    raise next(iter(done)).exception()
                logger.warning(
                    f"{label}: a racing transfer failed "
                    f"({type(next(iter(done)).exception()).__name__}); "
                    "waiting on the surviving one"
                )
            else:
                logger.warning(f"{label}: transfers still pending; waiting")

    def shutdown(self):
        # Stalled duplicate threads may survive; don't wait on them.
        if self._pool is not None:
            self._pool.shutdown(wait=False)


def _production_chunk(config: MCMCConfig, checkpoint_every: int | None) -> int | None:
    """Production dispatch-chunk size: the checkpoint cadence when set, else a
    single dispatch (None).
    ``BIQ_DISPATCH_CHUNK`` overrides for tuning (0 forces single dispatch)."""
    n = config.n_sampling_steps
    cadence = checkpoint_every or 0
    cadence = int(os.environ.get("BIQ_DISPATCH_CHUNK", cadence) or 0)
    if 0 < cadence < n:
        return cadence
    if cadence != 0 or "BIQ_DISPATCH_CHUNK" in os.environ:
        return None
    # Eighth (or quarter) dispatches of ONE shared scan program: earlier
    # chunks' chain slabs download while later chunks execute, hiding most of
    # the transfer; finer chunks start the first download sooner and keep the concurrent
    # fetch pool's streams full.
    if n >= 20000:
        for k in (8, 4):
            if n % k == 0:
                return n // k
    # Shorter runs: chunk at the acceptance-logging cadence so `MCMC step
    # N/total` lines appear DURING sampling (reference mcmc.py:194-204
    # behavior) instead of post-hoc from the downloaded trace. Chunks share
    # one compiled program only when equal-sized, so round n_logging_steps
    # into an even divisor of the run.
    log_every = getattr(config, "n_logging_steps", 0) or 0
    if 0 < log_every < n:
        k = max(1, round(n / log_every))
        while n % k:
            k -= 1
        if k > 1:
            return n // k
    return None


def _production_sizes(config: MCMCConfig, checkpoint_every: int | None) -> list[int] | None:
    """Dispatch-chunk size sequence for the production scan (None = single
    dispatch).

    Explicit cadence (``checkpoint_every`` / ``BIQ_DISPATCH_CHUNK``): uniform
    chunks at the cadence (checkpoint-boundary alignment keeps resume
    bit-exact). Default for long runs: a RAMPED sequence
    [n/32, n/32, n/16] (32 | n) or [n/16, n/16] (16 | n) followed by n/8
    chunks, with the LAST n/8 chunk split into two n/16 chunks — the first
    chain slab starts downloading after ~3-6% of the scan instead of 12.5%,
    so the concurrent fetch pool is busy from the start, and the final
    (only non-overlapped) download carries half the bytes; later chunks stay
    coarse; only 2-3 distinct chunk-program shapes total (each
    value-independent and persistent-cached). Falls back to the uniform
    _production_chunk layouts when 16 doesn't divide n or the run is short.
    """
    n = config.n_sampling_steps
    chunk = _production_chunk(config, checkpoint_every)
    if chunk is None:
        return None
    explicit = bool(checkpoint_every) or "BIQ_DISPATCH_CHUNK" in os.environ
    if not explicit and n >= 20000 and n % 16 == 0:
        lead = (
            [n // 32, n // 32, n // 16] if n % 32 == 0 else [n // 16, n // 16]
        )
        return lead + [n // 8] * 6 + [n // 16, n // 16]
    sizes = [chunk] * (n // chunk)
    if n % chunk:
        sizes.append(n % chunk)
    return sizes


def _read_checkpoint_records(path: str, n_total: int) -> list[dict[str, Any]]:
    """Read the append-only checkpoint stream; tolerates a truncated tail."""
    records: list[dict[str, Any]] = []
    with open(path, "rb") as f:
        try:
            header = pickle.load(f)
            if header.get("version") != 3 or header.get("n_total") != n_total:
                return []
            while True:
                records.append(pickle.load(f))
        except (EOFError, pickle.UnpicklingError):
            pass
    return records


def _log_acceptance_cadence(
    config: MCMCConfig, acc_trace: np.ndarray, offset: int = 0, prior_sum: float = 0.0
) -> None:
    """Emit the reference's per-n_logging_steps cumulative mean-acceptance lines
    (mcmc.py:194-204) from a downloaded per-step acceptance trace.

    ``offset``/``prior_sum``: steps already logged before this trace and the
    sum of their per-step mean acceptances (chunked-dispatch bookkeeping).
    """
    cadence = getattr(config, "n_logging_steps", 0) or 0
    n_total = config.n_sampling_steps
    if not cadence or acc_trace.size == 0:
        return
    cum = prior_sum + np.cumsum(acc_trace, dtype=np.float64)
    first = offset + ((cadence - offset) % cadence or cadence)
    for step in range(first, offset + acc_trace.size + 1, cadence):
        i = step - offset
        logger.info(
            f"MCMC step {step}/{n_total}: mean acceptance fraction: {cum[i - 1] / step:.3f}"
        )


def _run_production(
    config: MCMCConfig,
    key,
    log_prob_fn,
    x0,
    checkpoint_every: int | None,
    sizes: list[int] | None,
    programs=None,
    like=None,
) -> dict[str, Any]:
    """Production run: single-dispatch scan by default, chunked with streamed
    downloads when a ``sizes`` sequence is given (see _production_sizes).

    Chunks are dispatched back-to-back (jax async dispatch keeps the device
    pipeline full); each chunk's chain slab is then downloaded in completion
    order AND appended straight to mcmc.h5 (io/hdf5.py::append_time_series),
    so both the transfer and the disk write overlap device execution — the
    caller's final write covers metadata only (result key "streamed"=True).
    When ``checkpoint_every`` is set, per-chunk STATE-ONLY snapshots form
    append-only resumable checkpoints (step-granular resume the reference
    lists as an open TODO, mcmc.py:69-70); the streamed h5 is the durable
    chain store, trimmed to the snapshot step on resume. The snapshot carries
    the scan's in-flight log_prob — re-evaluating it at resume would pick up
    1-ulp fusion differences vs the scan body and break bit-exact resume.
    The acceptance-logging cadence comes from the scan's per-step acceptance
    trace in both paths.
    """
    from bayesian_inference_tpu.mcmc.stretch import EnsembleState, init_state, run_chunk

    def _init(k, x):
        if programs is not None:
            return programs.init(k, like, x)
        return init_state(k, log_prob_fn, x)

    def _chunk(state, n):
        if programs is not None:
            return programs.chunk(state, like, n)
        return run_chunk(state, log_prob_fn, n)

    n_total = config.n_sampling_steps
    if not sizes:
        state = _init(key, x0)
        state, ys = _chunk(state, n_total)
        # Device is executing the (async-dispatched) scan: use the idle host
        # to precompute the autocorrelation FFT plans for free.
        stats.warm_fft_plans(n_total)
        chain = np.asarray(ys[0])
        log_prob = np.asarray(ys[1])
        _log_acceptance_cadence(config, np.asarray(ys[2]))
        return {
            "coords": state.coords,
            "final_log_prob": state.log_prob,
            "acceptance_fraction": np.asarray(state.n_accepted).astype(float) / n_total,
            "chain": chain,
            "log_prob": log_prob,
            "key": state.key,
            # Device idle now (chain download completed): accelerator-side
            # tau spectrum + R-hat — see _device_chain_stats.
            **_device_chain_stats([ys[0]]),
        }

    path = _checkpoint_path(config)
    out_dir = config.mcmc_output_dir
    # Full-run output slabs, written chunk-by-chunk as downloads land: a
    # preallocated slab replaces the end-of-run np.concatenate of all chunk
    # arrays (~1 s of host copy on the 1-vCPU bench host, measured
    # 2026-08-20) with per-chunk writes that overlap the remaining downloads.
    W_, ndim_ = x0.shape
    out_dt = np.dtype(str(x0.dtype))
    chain_slab = np.empty((n_total, W_, ndim_), out_dt)
    logp_slab = np.empty((n_total, W_), out_dt)
    resume_prefix = 0
    acc_offset = np.zeros(x0.shape[0], np.int64)
    steps_done = 0
    state = None

    ckpt_file = None
    if checkpoint_every:
        os.makedirs(out_dir, exist_ok=True)
        if os.path.exists(path):
            records = _read_checkpoint_records(path, n_total)
            if records and records[-1]["steps_done"] < n_total:
                last = records[-1]
                logger.info(f"Resuming production from checkpoint at step {last['steps_done']}")
                acc_offset = last["n_accepted"]
                steps_done = last["steps_done"]
                state = EnsembleState(
                    coords=jnp.asarray(last["coords"]),
                    log_prob=jnp.asarray(last["log_prob"]),
                    n_accepted=jnp.zeros(x0.shape[0], jnp.int32),
                    key=jax.random.wrap_key_data(jnp.asarray(last["key_data"])),
                )
                # Durable chain prefix = streamed h5, trimmed to the snapshot
                # step (drops any slab written after the last complete record),
                # then read back so the caller still gets the full chain.
                n_have = hdf5.time_series_length(out_dir, "mcmc.h5", "chain")
                if n_have < steps_done:
                    raise RuntimeError(
                        f"checkpoint at step {steps_done} but streamed chain has "
                        f"only {n_have} steps — artifacts are inconsistent; "
                        "delete mcmc_checkpoint.pkl to restart"
                    )
                ds = hdf5.read_datasets(out_dir, "mcmc.h5", ["chain", "log_prob"])
                chain_slab[:steps_done] = ds["chain"][:steps_done]
                logp_slab[:steps_done] = ds["log_prob"][:steps_done]
                resume_prefix = steps_done
                if n_have != steps_done:
                    hdf5.append_time_series(
                        out_dir, "mcmc.h5",
                        {"chain": chain_slab[:0], "log_prob": logp_slab[:0]},
                        truncate_to=steps_done,
                    )
                # Rewrite header + complete records once (truncated tails drop).
                with open(path, "wb") as f:
                    pickle.dump({"version": 3, "n_total": n_total}, f)
                    for r in records:
                        pickle.dump(r, f)
                ckpt_file = open(path, "ab")
        if ckpt_file is None:
            ckpt_file = open(path, "wb")
            pickle.dump({"version": 3, "n_total": n_total}, ckpt_file)

    if state is None:
        # fresh run: drop any stale streamed chain from an earlier attempt
        h5_path = os.path.join(out_dir, "mcmc.h5")
        if os.path.exists(h5_path):
            os.remove(h5_path)
        state = _init(key, x0)

    # Dispatch every chunk up front; snapshot per-chunk state (device handles).
    pending = []
    if steps_done:
        # Resume only happens under an explicit checkpoint cadence (uniform
        # sizes); rebuild the uniform tail so chunk boundaries stay aligned
        # with the uninterrupted run (RNG streams derive per chunk).
        cadence = sizes[0]
        remaining = n_total - steps_done
        sizes = [cadence] * (remaining // cadence)
        if remaining % cadence:
            sizes.append(remaining % cadence)
    t_prod0 = _time.perf_counter()
    quant = _ChainQuantizer.from_config(config, like)
    if quant is not None:
        # device idle here (burn-in downloaded): safe to first-exec/compile
        W, ndim = x0.shape
        quant.prewarm([(n, W, ndim) for n in sorted(set(sizes))])
    t_prewarm = _time.perf_counter()
    for n in sizes:
        state, ys = _chunk(state, n)
        qc = quant.quantize(ys[0]) if quant is not None else None
        ql = quant.quantize_logp(ys[1]) if quant is not None else None
        pending.append((n, ys, qc, ql, state))
    t_dispatch = _time.perf_counter()
    stats.warm_fft_plans(n_total)  # host idle while the device executes
    t_fft = _time.perf_counter()

    # Download with a small thread pool, process/write strictly in dispatch
    # order: np.asarray blocks on chunk k while k+1.. execute, so transfers
    # overlap both device execution AND each other.
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=4)
    fetches = [
        (n, pool.submit(_fetch, ys[0] if qc is None else qc),
         pool.submit(_fetch, ys[1] if ql is None else ql),
         pool.submit(np.asarray, ys[2]), ys, qc, ql, snap)
        for n, ys, qc, ql, snap in pending
    ]
    trace_sum = float(acc_offset.mean())  # sum of per-step mean acceptance so far
    hedge = _HedgedFetcher()
    chunk_done: list[float] = []
    t_prev_arr = _time.perf_counter()
    for n, f_chain, f_logp, f_trace, ys, qc, ql, snap in fetches:
        nb_chain = _nbytes(ys[0] if qc is None else qc)
        nb_logp = _nbytes(ys[1] if ql is None else ql)
        fired0 = hedge.fired
        raw = hedge.result(
            f_chain, ys[0] if qc is None else qc, "chain chunk", nbytes=nb_chain
        )
        chain_slab[steps_done:steps_done + n] = (
            raw if quant is None else quant.dequantize(raw)
        )
        raw_lp = hedge.result(
            f_logp, ys[1] if ql is None else ql, "log-prob chunk", nbytes=nb_logp
        )
        logp_slab[steps_done:steps_done + n] = (
            raw_lp if quant is None else quant.dequantize_logp(raw_lp)
        )
        t_arr = _time.perf_counter()
        if hedge.fired == fired0:
            # clean arrival: feed the adaptive hedge's link-rate estimate
            # (interval may include device-exec wait -> conservative)
            hedge.observe(nb_chain + nb_logp, t_arr - t_prev_arr)
        t_prev_arr = t_arr
        hdf5.append_time_series(
            out_dir, "mcmc.h5",
            {"chain": chain_slab[steps_done:steps_done + n],
             "log_prob": logp_slab[steps_done:steps_done + n]},
        )
        tr = hedge.result(f_trace, ys[2], "acceptance trace", nbytes=_nbytes(ys[2]))
        _log_acceptance_cadence(config, tr, offset=steps_done, prior_sum=trace_sum)
        trace_sum += float(tr.sum(dtype=np.float64))
        steps_done += n
        acc_cum = acc_offset + np.asarray(snap.n_accepted, np.int64)
        if ckpt_file is not None:
            pickle.dump({
                "steps_done": steps_done,
                "n_accepted": acc_cum,
                "coords": np.asarray(snap.coords),
                "log_prob": np.asarray(snap.log_prob),
                "key_data": np.asarray(jax.random.key_data(snap.key)),
            }, ckpt_file)
            ckpt_file.flush()
        chunk_done.append(_time.perf_counter())
    pool.shutdown()
    hedge.shutdown()
    logger.debug(
        "production breakdown: prewarm %.2fs, dispatch %.2fs, fft-warm %.2fs, "
        "chunk download+write+ckpt completions at %s (s from production start)",
        t_prewarm - t_prod0,
        t_dispatch - t_prewarm,
        t_fft - t_dispatch,
        ", ".join(f"{t - t_prod0:.2f}" for t in chunk_done),
    )

    if ckpt_file is not None:
        ckpt_file.close()
        os.remove(path)

    t_tail = _time.perf_counter()
    final_acc = acc_offset + np.asarray(state.n_accepted, np.int64)
    t_acc = _time.perf_counter()
    # All chunks executed + downloaded (device idle): accelerator-side tau
    # spectrum + R-hat over the full chain. Device slabs are still alive in
    # ``pending``; a resumed host prefix (the slab's h5-read head) uploads
    # once. The chunk arrays were written straight into the preallocated
    # output slabs during streaming — no end-of-run concatenate.
    dev_pieces = ([chain_slab[:resume_prefix]] if resume_prefix else []) + [
        ys[0] for _, ys, _qc, _ql, _ in pending
    ]
    dev_stats = _device_chain_stats(dev_pieces)
    logger.debug(
        "production tail: final-acc fetch %.2fs, device stats dispatch %.2fs",
        t_acc - t_tail, _time.perf_counter() - t_acc,
    )
    return {
        "coords": state.coords,
        "final_log_prob": state.log_prob,
        "acceptance_fraction": final_acc.astype(float) / n_total,
        "chain": chain_slab,
        "log_prob": logp_slab,
        "key": state.key,
        "streamed": True,
        **dev_stats,
    }
