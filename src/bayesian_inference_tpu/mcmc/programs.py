"""AOT-compiled sampler executables with value-independent cache keys.

Why this exists: a sampler lax.scan program that closes over the fitted
emulator arrays bakes their VALUES into the HLO as constants. Every run's fit
produces (slightly) different values, so the persistent compilation cache
would never hit and each MCMC would pay a fresh compile. Passing the
likelihood pytree as a runtime operand makes the program value-independent:

* stable persistent-cache keys across runs, and
* the executables can be traced + compiled from ``jax.ShapeDtypeStruct`` specs
  alone — no fit output needed.

The shape spec is derived from the config + observables file via placeholder
(zero-valued) emulator artifacts run through the real ``build_likelihood``
path, so the operand treedef matches the eventual fitted likelihood by
construction.

Programs compile synchronously, before the device executes anything else.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Sequence

import jax
import numpy as np

from bayesian_inference_tpu.io import observables as obs_io
from bayesian_inference_tpu.mcmc.likelihood import EmulatorLikelihood, build_likelihood
from bayesian_inference_tpu.mcmc.stretch import EnsembleState, init_state, run_chunk

logger = logging.getLogger(__name__)


def logp_operand(like: EmulatorLikelihood, x: jax.Array) -> jax.Array:
    """Module-level operand-style log-posterior (stable identity for jit keys)."""
    return like.log_posterior(x)


def _sharded_logp_operand(mesh):
    """Operand-style log-posterior with the walker batch partitioned over the
    mesh (parallel/mesh.py semantics). Fresh closure per mesh — fine for the
    AOT path, where cache identity comes from the lowered HLO, not the
    Python callable."""
    from bayesian_inference_tpu.parallel.mesh import make_sharded_log_prob

    def logp(like: EmulatorLikelihood, x: jax.Array) -> jax.Array:
        return make_sharded_log_prob(like.log_posterior, mesh)(x)

    return logp


# --------------------------------------------------------------------------------------
# Shape spec without a fit
# --------------------------------------------------------------------------------------

def _placeholder_group_artifact(group_config) -> dict[str, Any]:
    """A zero-valued emulator artifact with the exact shapes the fit would
    produce (schema: models/emulator.py::_artifact_from_fit). Only the keys
    consumed by build_likelihood / posterior_from_artifact /
    compute_emulator_cov_unexplained are populated."""
    Y = obs_io.predictions_matrix_from_h5(
        group_config.output_dir,
        filename=group_config.observables_filename,
        observable_filter=group_config.observable_filter,
    )
    design = obs_io.design_array_from_h5(
        group_config.output_dir, filename=group_config.observables_filename
    )
    n, d = design.shape
    F = Y.shape[1]
    n_comp = min(n, F)
    if group_config.max_n_components_to_calculate:
        n_comp = min(n_comp, group_config.max_n_components_to_calculate)
    k = group_config.n_pc
    cfg = group_config.kernel_config()
    return {
        "PCA": {
            "mean": np.zeros(F),
            "scale": np.ones(F),
            "components": np.zeros((n_comp, F)),
            "explained_variance": np.ones(n_comp),
            "explained_variance_ratio": np.full(n_comp, 1.0 / n_comp),
            "singular_values": np.ones(n_comp),
        },
        "emulators": {
            "kernel": {"nu": cfg.nu, "with_noise": cfg.with_noise, "with_constant": cfg.with_constant},
            "alpha_jitter": group_config.alpha,
            "X": np.zeros((n, d)),
            "params": {
                "log_length_scale": np.zeros((k, d)),
                "log_noise": np.zeros(k),
                "log_constant": np.zeros(k),
            },
            "alpha": np.zeros((k, n)),
            "Kinv": np.zeros((k, n, n)),
            "prior_var": np.ones(k),
            "lml": np.zeros(k),
        },
        "n_pc": k,
    }


def likelihood_shape_spec(
    emulation_config,
    theta_min: Sequence[float],
    theta_max: Sequence[float],
    mode: str = "block",
    dtype=None,
) -> EmulatorLikelihood:
    """ShapeDtypeStruct pytree of the likelihood a future fit will produce."""
    from bayesian_inference_tpu.models.emulator import GroupSliceMap

    placeholder = {
        name: _placeholder_group_artifact(cfg)
        for name, cfg in emulation_config.emulation_groups_config.items()
    }
    n_features = GroupSliceMap.learn(emulation_config).n_features
    like = build_likelihood(
        emulation_config,
        placeholder,
        {"y": np.zeros(n_features), "y_err": np.ones(n_features)},
        theta_min=theta_min,
        theta_max=theta_max,
        mode=mode,
        dtype=dtype,
    )
    return jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), like)


# --------------------------------------------------------------------------------------
# AOT program cache
# --------------------------------------------------------------------------------------

class SamplerPrograms:
    """AOT-compiled init/chunk executables for one (likelihood-shape, W, d).

    ``compile()`` may run on a background thread; every accessor blocks until
    it finishes. On any compile failure the runner falls back to the plain
    jit path (``ok`` returns False).
    """

    def __init__(
        self,
        like_spec: EmulatorLikelihood,
        n_walkers: int,
        ndim: int,
        chunk_sizes: Sequence[int],
        mesh=None,
    ):
        """``mesh``: a jax.sharding.Mesh — the executables are lowered with
        every INPUT replicated over the mesh and the walker batch partitioned
        inside the program (same semantics as the jit-closure mesh path), so
        multi-chip runs keep the value-independent persistent-cache keys."""
        self.mesh = mesh
        self._sharding = None
        self._logp = logp_operand
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            self._sharding = NamedSharding(mesh, PartitionSpec())
            self._logp = _sharded_logp_operand(mesh)

        def _sds(shape, dtype):
            if self._sharding is None:
                return jax.ShapeDtypeStruct(shape, dtype)
            return jax.ShapeDtypeStruct(shape, dtype, sharding=self._sharding)

        self.like_spec = jax.tree.map(lambda a: _sds(a.shape, a.dtype), like_spec)
        self.n_walkers = n_walkers
        self.ndim = ndim
        dt = self.like_spec.theta_min.dtype
        key_spec = jax.eval_shape(lambda: jax.random.key(0))
        key_spec = _sds(key_spec.shape, key_spec.dtype)
        self._state_spec = EnsembleState(
            coords=_sds((n_walkers, ndim), dt),
            log_prob=_sds((n_walkers,), dt),
            n_accepted=_sds((n_walkers,), np.int32),
            key=key_spec,
        )
        self._key_spec = key_spec
        self._x0_spec = _sds((n_walkers, ndim), dt)
        self._chunk_sizes = sorted(set(int(n) for n in chunk_sizes if n > 0))
        self._init_exe = None
        self._chunk_exe: dict[int, Any] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.error: Exception | None = None

    def _place(self, tree):
        """Commit a pytree to the executables' (replicated) input sharding.
        No-op copies when already placed; required because AOT executables
        reject inputs committed to a single device of a multi-device mesh."""
        if self._sharding is None:
            return tree
        return jax.device_put(tree, self._sharding)

    # -- compilation -------------------------------------------------------------
    def compile(self) -> None:
        """Trace + compile (or load from the persistent cache) every program."""
        import time as _time

        try:
            t0 = _time.perf_counter()
            self._init_exe = init_state.lower(
                self._key_spec, self._logp, self._x0_spec, aux=self.like_spec
            ).compile()
            for n in self._chunk_sizes:
                self._compile_chunk(n)
            logger.info(
                f"sampler programs ready (init + scan{self._chunk_sizes}"
                + (f", {self.mesh.devices.size}-device mesh" if self.mesh is not None else "")
                + f"): {_time.perf_counter() - t0:.2f}s"
            )
        except Exception as e:  # fall back to the jit path in the runner
            logger.warning(f"sampler AOT compile failed ({e!r}); jit fallback")
            self.error = e
        finally:
            self._done.set()

    def _compile_chunk(self, n: int) -> None:
        self._chunk_exe[n] = run_chunk.lower(
            self._state_spec, self._logp, n, aux=self.like_spec
        ).compile()

    def compile_async(self) -> "SamplerPrograms":
        threading.Thread(target=self.compile, daemon=True, name="sampler-prewarm").start()
        return self

    def ok(self) -> bool:
        self._done.wait()
        return self.error is None

    # -- execution ---------------------------------------------------------------
    def init(self, key, like: EmulatorLikelihood, x0) -> EnsembleState:
        self._done.wait()
        key, x0, like = self._place(key), self._place(x0), self._place(like)
        return self._init_exe(key, x0, aux=like)

    def chunk(self, state: EnsembleState, like: EmulatorLikelihood, n_steps: int):
        """(state, (coords, log_prob, accept) per step) for an n_steps advance."""
        self._done.wait()
        if n_steps not in self._chunk_exe:
            with self._lock:
                if n_steps not in self._chunk_exe:
                    logger.info(f"compiling sampler chunk program for {n_steps} steps")
                    self._compile_chunk(n_steps)
        state, like = self._place(state), self._place(like)
        return self._chunk_exe[n_steps](state, aux=like)


def chunk_sizes_for_config(config, checkpoint_every: int | None = None) -> list[int]:
    """The scan lengths run_mcmc will dispatch for this config."""
    from bayesian_inference_tpu.mcmc.runner import _production_sizes

    nburn0 = config.n_burn_steps // 2
    nburn1 = config.n_burn_steps - nburn0
    sizes = {nburn0, nburn1}
    prod = _production_sizes(config, checkpoint_every)
    sizes.update(prod if prod else [config.n_sampling_steps])
    return sorted(s for s in sizes if s > 0)


def prewarm_sampler_programs(
    config,
    mode: str | None = None,
    dtype=None,
    checkpoint_every: int | None = None,
    threaded: bool = False,
    mesh=None,
) -> SamplerPrograms | None:
    """Compile the MCMC executables ahead of ``run_mcmc``.

    Requires the observables file (for shapes) but NOT the fit. Pass the
    result to ``run_mcmc`` as ``programs=``. Both likelihood modes have an
    operand-style path — the lowrank (Woodbury) state is a pytree like the
    bucketed block tensors, so its executables are equally value-independent.
    Returns None for an unknown mode.

    ``threaded=True`` compiles on a daemon thread, overlapping the compile
    with whatever the device runs meanwhile.
    """
    from bayesian_inference_tpu.mcmc.runner import _existing_observables_file
    from bayesian_inference_tpu.pipeline.configs import EmulationConfig

    if mode is None:
        mode = getattr(config, "likelihood_mode", "block")
    if mode not in ("block", "lowrank"):
        return None

    emulation_config = EmulationConfig.from_config_file(
        analysis_name=config.analysis_name,
        parameterization=config.parameterization,
        analysis_config=config.analysis_config,
        config_file=config.config_file,
    )
    # Shapes must come from a file that exists NOW (the preprocessed file may
    # not be written yet when prewarm starts before the preprocess stage).
    obs_filename = _existing_observables_file(config)
    emulation_config.observables_filename = obs_filename
    for group_config in emulation_config.emulation_groups_config.values():
        group_config.observables_filename = obs_filename
    spec = likelihood_shape_spec(
        emulation_config,
        theta_min=np.asarray(config.parameterization_spec()["min"], float),
        theta_max=np.asarray(config.parameterization_spec()["max"], float),
        mode=mode,
        dtype=dtype,
    )
    programs = SamplerPrograms(
        spec,
        n_walkers=config.n_walkers,
        ndim=len(config.parameterization_spec()["names"]),
        chunk_sizes=chunk_sizes_for_config(config, checkpoint_every),
        mesh=mesh,
    )
    if threaded:
        return programs.compile_async()
    programs.compile()
    return programs
