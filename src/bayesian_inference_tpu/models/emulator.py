"""Emulator stack: per-group PCA + GP fit, persistence, group-merged prediction.

Replaces reference emulation.py. Each emulation group (disjoint observable
subset) gets its own scaler+PCA and one GP per retained principal component;
groups are fit in a single device launch each (PCs x restarts vmapped) and
merged predictions follow the reference's slice/block-diagonal convention:

  - central values: group blocks inserted at the globally-sorted feature slices
  - covariance: per-OBSERVABLE diagonal blocks only (the reference's
    SortEmulationGroupObservables.convert, emulation.py:346-406, discards
    cross-observable covariance at merge; we preserve that contract, and the
    MCMC likelihood exploits it -- see mcmc/likelihood.py)

Artifacts are plain dicts of numpy arrays pickled to the reference filenames
(emulation.pkl / emulation_group_<name>.pkl).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import numpy.typing as npt

from bayesian_inference_tpu.io import hdf5, observables as obs_io
from bayesian_inference_tpu.models import gp as gp_mod
from bayesian_inference_tpu.models import gp_fit
from bayesian_inference_tpu.models import pca as pca_mod
from bayesian_inference_tpu.ops.gram import KernelConfig, KernelParams
from bayesian_inference_tpu.pipeline.configs import EmulationConfig, EmulationGroupConfig

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------------------
# Fit + persistence
# --------------------------------------------------------------------------------------

def _fit_gate_open(config: EmulationGroupConfig) -> bool:
    """True when this group needs (re)fitting; removes stale output when forced
    (reference skip-if-exists gate, emulation.py:63-70)."""
    if os.path.exists(config.emulation_outputfile):
        if config.force_retrain:
            os.remove(config.emulation_outputfile)
            logger.info(f"Removed {config.emulation_outputfile}")
        else:
            logger.info(f"Emulators already exist: {config.emulation_outputfile}")
            return False
    return True


def _prepare_group(
    config: EmulationGroupConfig, n_opt_iters: int, observables: dict[str, Any] | None = None
) -> dict[str, Any]:
    """Host-side setup for one group: prediction matrix, PCA, design, fit spec.

    ``observables``: optional pre-read h5 dict; ``fit_emulators`` loads each
    distinct observables file ONCE and shares it across groups (full-file h5
    reads are ~0.2 s each at production width — per-group re-reads were the
    largest piece of the bench fit phase).
    """
    if observables is None:
        from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

        observables = read_dict_from_h5(config.output_dir, config.observables_filename, verbose=False)
    Y = obs_io.predictions_matrix_from_h5(
        config.output_dir, filename=config.observables_filename,
        observable_filter=config.observable_filter, observables=observables,
    )
    state, Y_pca = pca_mod.fit_pca(Y, max_n_components=config.max_n_components_to_calculate)
    n_pc = config.n_pc
    evr = np.asarray(state.explained_variance_ratio)
    logger.info(f"Variance explained by first {n_pc} components: {evr[:n_pc].sum()}")
    design = observables["Design"]
    return {
        "Y": Y,
        "state": state,
        "Y_pca": Y_pca,
        "Y_pca_truncated": Y_pca[:, :n_pc],
        "design": design,
        "spec": config.fit_spec(n_iters=n_opt_iters),
        "n_pc": n_pc,
    }


def _log_fit_summary(posts) -> None:
    lmls = np.asarray(posts.lml)
    lss = np.exp(np.asarray(posts.params.log_length_scale))
    noises = np.exp(np.asarray(posts.params.log_noise))
    for i in range(lmls.shape[0]):
        logger.info(f"  PC {i}: LML={lmls[i]:.3f} ls={lss[i].round(3)} noise={noises[i]:.4f}")


def _artifact_from_fit(config: EmulationGroupConfig, prep: dict[str, Any], posts) -> dict[str, Any]:
    state = prep["state"]
    n_pc = prep["n_pc"]
    Y_pca_truncated = np.asarray(prep["Y_pca_truncated"])
    Y_recon = Y_pca_truncated @ np.asarray(state.components)[:n_pc]
    Y_recon_unscaled = Y_recon * np.asarray(state.scale) + np.asarray(state.mean)

    cfg = config.kernel_config()
    return {
        "PCA": {
            "Y": np.asarray(prep["Y"]),
            "Y_pca": np.asarray(prep["Y_pca"]),
            "Y_pca_truncated": Y_pca_truncated,
            "Y_reconstructed_truncated": Y_recon,
            "Y_reconstructed_truncated_unscaled": Y_recon_unscaled,
            **{k: np.asarray(v) for k, v in state.to_host_dict().items()},
        },
        "emulators": {
            "kernel": {"nu": cfg.nu, "with_noise": cfg.with_noise, "with_constant": cfg.with_constant},
            "alpha_jitter": config.alpha,
            "X": np.asarray(prep["design"]),
            "params": {
                "log_length_scale": np.asarray(posts.params.log_length_scale),
                "log_noise": np.asarray(posts.params.log_noise),
                "log_constant": np.asarray(posts.params.log_constant),
            },
            "alpha": np.asarray(posts.alpha),
            "Kinv": np.asarray(posts.Kinv),
            "prior_var": np.asarray(posts.prior_var),
            "lml": np.asarray(posts.lml),
        },
        "n_pc": n_pc,
    }


def fit_emulator_group(
    config: EmulationGroupConfig,
    seed: int = 0,
    n_opt_iters: int = 60,
) -> dict[str, Any]:
    """PCA + vmapped GP fit for one emulation group; returns the artifact dict.

    Returns {} when the output file already exists and force_retrain is False.
    """
    if not _fit_gate_open(config):
        return {}
    prep = _prepare_group(config, n_opt_iters)
    spec = prep["spec"]
    logger.info(
        f"Fitting {prep['n_pc']} GPs x {spec.n_restarts + 1} restarts (design: {prep['design'].shape})..."
    )
    posts = gp_fit.fit_gps(
        spec, jnp.asarray(prep["design"], prep["Y_pca_truncated"].dtype),
        prep["Y_pca_truncated"], jax.random.key(seed),
    )
    _log_fit_summary(posts)
    return _artifact_from_fit(config, prep, posts)


def _specs_compatible(a, b) -> bool:
    return (
        a.cfg == b.cfg
        and a.n_restarts == b.n_restarts
        and a.n_iters == b.n_iters
        and a.alpha_jitter == b.alpha_jitter
        and np.array_equal(np.asarray(a.theta0), np.asarray(b.theta0))
        and np.array_equal(np.asarray(a.log_lo), np.asarray(b.log_lo))
        and np.array_equal(np.asarray(a.log_hi), np.asarray(b.log_hi))
    )


def fit_emulators(emulation_config: EmulationConfig, seed: int = 0, n_opt_iters: int = 60) -> None:
    """Fit and persist every emulation group (reference fit_emulators, emulation.py:38-50).

    When all pending groups share identical fit settings (the common case:
    YAML anchor-shared emulator parameters), their PCs are fitted in ONE fused
    device launch — one XLA compile and one fully-batched optimization instead
    of one per group.
    """
    import time as _time

    pending: dict[str, dict[str, Any]] = {}
    _t0 = _time.perf_counter()
    obs_cache: dict[tuple[str, str], dict[str, Any]] = {}
    for name, group_config in emulation_config.emulation_groups_config.items():
        if _fit_gate_open(group_config):
            fkey = (group_config.output_dir, group_config.observables_filename)
            if fkey not in obs_cache:
                from bayesian_inference_tpu.io.hdf5 import read_dict_from_h5

                obs_cache[fkey] = read_dict_from_h5(*fkey, verbose=False)
            pending[name] = _prepare_group(group_config, n_opt_iters, observables=obs_cache[fkey])
    if not pending:
        return
    logger.info(f"fit stage: ingest+PCA prep {_time.perf_counter() - _t0:.2f}s")

    names = list(pending)
    specs = [pending[n]["spec"] for n in names]
    fuse = len(names) > 1 and all(_specs_compatible(specs[0], s) for s in specs[1:])

    if fuse:
        spec = specs[0]
        # Host-side concat + a single upload each (an eager device concat
        # would compile a tiny program of its own).
        Y_all = jnp.asarray(np.concatenate([np.asarray(pending[n]["Y_pca_truncated"]) for n in names], axis=1))
        design = jnp.asarray(np.asarray(pending[names[0]]["design"], Y_all.dtype))
        logger.info(
            f"Fused GP fit: {Y_all.shape[1]} PCs across {len(names)} groups x "
            f"{spec.n_restarts + 1} restarts (design: {design.shape})..."
        )
        _t0 = _time.perf_counter()
        posts_all = gp_fit.fit_gps(spec, design, Y_all, jax.random.key(seed))
        # One device->host transfer, then pure-numpy slicing (eager device
        # slices would compile one tiny program per offset).
        posts_all = jax.tree.map(np.asarray, posts_all)
        logger.info(f"fit stage: fused fit_gps exec+download {_time.perf_counter() - _t0:.2f}s")
        _t0 = _time.perf_counter()
        offset = 0
        for n in names:
            k = pending[n]["n_pc"]
            posts = jax.tree.map(lambda x, o=offset, k=k: x[o : o + k], posts_all)
            _log_fit_summary(posts)
            artifact = _artifact_from_fit(emulation_config.emulation_groups_config[n], pending[n], posts)
            write_emulators(emulation_config.emulation_groups_config[n], artifact)
            offset += k
        logger.info(f"fit stage: artifacts+writes {_time.perf_counter() - _t0:.2f}s")
    else:
        for n in names:
            prep = pending[n]
            spec = prep["spec"]
            posts = gp_fit.fit_gps(
                spec, jnp.asarray(prep["design"], prep["Y_pca_truncated"].dtype),
                prep["Y_pca_truncated"], jax.random.key(seed),
            )
            _log_fit_summary(posts)
            artifact = _artifact_from_fit(emulation_config.emulation_groups_config[n], prep, posts)
            write_emulators(emulation_config.emulation_groups_config[n], artifact)


def write_emulators(config: EmulationGroupConfig, artifact: dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(config.emulation_outputfile), exist_ok=True)
    with open(config.emulation_outputfile, "wb") as f:
        pickle.dump(artifact, f)


def read_emulators(config: EmulationGroupConfig) -> dict[str, Any]:
    with open(config.emulation_outputfile, "rb") as f:
        return pickle.load(f)


def posterior_from_artifact(
    artifact: dict[str, Any], device: bool = True
) -> tuple[KernelConfig, gp_mod.GPPosterior]:
    """Rehydrate the stacked GPPosterior (leading axis = PC) from a host artifact.

    ``device=False`` keeps all leaves as host numpy arrays (callers that fuse
    or slice before transfer avoid per-leaf device round trips).
    """
    em = artifact["emulators"]
    cfg = KernelConfig(**em["kernel"])
    k = em["alpha"].shape[0]
    conv = jnp.asarray if device else np.asarray
    X = np.broadcast_to(np.asarray(em["X"]), (k, *em["X"].shape))
    posts = gp_mod.GPPosterior(
        params=KernelParams(
            log_length_scale=conv(em["params"]["log_length_scale"]),
            log_noise=conv(em["params"]["log_noise"]),
            log_constant=conv(em["params"]["log_constant"]),
        ),
        X=conv(X),
        alpha=conv(em["alpha"]),
        Kinv=conv(em["Kinv"]),
        prior_var=conv(em["prior_var"]),
        lml=conv(em["lml"]),
    )
    return cfg, posts


def pca_state_from_artifact(artifact: dict[str, Any]) -> pca_mod.PCAState:
    """Rehydrate the PCA state with HOST numpy leaves: every consumer
    (truncation covariance, plot-layer reconstructions) is setup/diagnostic
    math where eager device ops would each compile a tiny remote program."""
    p = artifact["PCA"]
    return pca_mod.PCAState(
        mean=np.asarray(p["mean"]),
        scale=np.asarray(p["scale"]),
        components=np.asarray(p["components"]),
        explained_variance=np.asarray(p["explained_variance"]),
        explained_variance_ratio=np.asarray(p["explained_variance_ratio"]),
        singular_values=np.asarray(p["singular_values"]),
    )


# --------------------------------------------------------------------------------------
# Truncation covariance
# --------------------------------------------------------------------------------------

def compute_emulator_group_cov_unexplained(
    emulation_group_config: EmulationGroupConfig, emulation_group_result: dict[str, Any]
) -> npt.NDArray[np.float64]:
    """Sigma_unexplained in *scaled* feature space (eqs 21-22 of arXiv:2102.11337;
    reference emulation.py:227-251)."""
    state = pca_state_from_artifact(emulation_group_result)
    return np.asarray(pca_mod.truncation_covariance(state, emulation_group_config.n_pc))


def compute_emulator_cov_unexplained(
    emulation_config: EmulationConfig, emulation_results: dict[str, Any] | None = None
) -> dict[str, npt.NDArray[np.float64]]:
    if not emulation_results:
        emulation_results = emulation_config.read_all_emulator_groups()
    return {
        name: compute_emulator_group_cov_unexplained(cfg, emulation_results[name])
        for name, cfg in emulation_config.emulation_groups_config.items()
    }


# --------------------------------------------------------------------------------------
# Group -> globally-sorted-observable merge
# --------------------------------------------------------------------------------------

@dataclasses.dataclass
class GroupSliceMap:
    """Mapping from per-group feature matrices to the globally sorted observable matrix.

    entries: per observable (in global sorted order):
        (observable_label, group_name, global_slice, group_slice)
    n_features: total global feature count.
    """

    entries: list[tuple[str, str, slice, slice]]
    n_features: int

    @classmethod
    def learn(cls, emulation_config: EmulationConfig) -> "GroupSliceMap":
        # The slice map is learned from the configured observables file so a
        # preprocessed run is consistent end-to-end. (The reference hardcodes
        # 'observables.h5' here, emulation.py:304 — harmless there because
        # preprocessing never changes binning, but we honor the config.)
        all_obs = hdf5.read_dict_from_h5(
            emulation_config.output_dir,
            emulation_config.observables_filename,
            verbose=False,
        )
        pred = all_obs["Prediction"]

        global_slices: dict[str, slice] = {}
        pos = 0
        for label in obs_io.sorted_observable_list_from_dict(pred):
            n_bins = np.atleast_2d(pred[label]["y"]).shape[0]
            global_slices[label] = slice(pos, pos + n_bins)
            pos += n_bins

        by_label: dict[str, tuple[str, slice, slice]] = {}
        for group_name, group_cfg in emulation_config.emulation_groups_config.items():
            group_pos = 0
            for label in obs_io.sorted_observable_list_from_dict(pred, observable_filter=group_cfg.observable_filter):
                g_slice = global_slices[label]
                width = g_slice.stop - g_slice.start
                by_label[label] = (group_name, g_slice, slice(group_pos, group_pos + width))
                group_pos += width

        entries = [
            (label, *by_label[label]) for label in global_slices if label in by_label
        ]
        return cls(entries=entries, n_features=pos)

    def merge(self, group_matrices: dict[str, dict[str, npt.NDArray]]) -> dict[str, npt.NDArray]:
        """Merge per-group predictions into global arrays (reference convert()).

        central_value: (B, n_features); cov: block-diagonal per observable,
        (B, n_features, n_features).
        """
        out: dict[str, npt.NDArray] = {}
        value_types = {vt for g in group_matrices.values() for vt in g}

        if "central_value" in value_types:
            B = next(iter(group_matrices.values()))["central_value"].shape[0]
            merged = np.zeros((B, self.n_features))
            for _, group, g_slice, grp_slice in self.entries:
                merged[:, g_slice] = group_matrices[group]["central_value"][:, grp_slice]
            out["central_value"] = merged

        if "cov" in value_types:
            B = next(iter(group_matrices.values()))["cov"].shape[0]
            cov = np.zeros((B, self.n_features, self.n_features))
            for _, group, g_slice, grp_slice in self.entries:
                cov[:, g_slice, g_slice] = group_matrices[group]["cov"][:, grp_slice, grp_slice]
            out["cov"] = cov
        return out


# --------------------------------------------------------------------------------------
# Prediction
# --------------------------------------------------------------------------------------

def predict_emulation_group(
    parameters: npt.NDArray[np.float64],
    results: dict[str, Any],
    n_pc: int | None = None,
    emulator_group_cov_unexplained: npt.NDArray[np.float64] | None = None,
    scale_cov_unexplained_by_n_samples: bool = True,
) -> dict[str, npt.NDArray[np.float64]]:
    """Emulator central values + covariance for one group.

    central_value: (B, F) = unscale(z @ S_k) ; cov: (B, F, F) =
    scale x [S_k diag(v) S_k^T + Sigma_unexplained (/B)] x scale.

    ``scale_cov_unexplained_by_n_samples`` reproduces the reference's division
    of the truncation covariance by the number of prediction samples
    (emulation.py:531-532). In the reference's production MCMC each walker is a
    separate call (B=1), so the likelihood path uses the undivided form; keep
    the flag True only for API parity with reference batch predictions.
    """
    if n_pc is None:
        n_pc = int(results["n_pc"])
    cfg, posts = posterior_from_artifact(results)
    state = pca_state_from_artifact(results)
    if emulator_group_cov_unexplained is None:
        emulator_group_cov_unexplained = np.asarray(pca_mod.truncation_covariance(state, n_pc))

    theta = jnp.asarray(parameters, jax.dtypes.canonicalize_dtype(state.components.dtype))
    z, v = gp_mod.predict_all_jit(cfg, posts, theta)  # (B, k), (B, k)
    z, v = np.asarray(z), np.asarray(v)

    S_k = np.asarray(state.components[:n_pc])         # (k, F)
    scale = np.asarray(state.scale)
    mean = np.asarray(state.unscale_features(z @ S_k))  # host math: numpy leaves

    B = parameters.shape[0]
    cov_scaled = np.einsum("fk,bk,gk->bfg", S_k.T, v, S_k.T, optimize=True)
    sigma = emulator_group_cov_unexplained / B if scale_cov_unexplained_by_n_samples else emulator_group_cov_unexplained
    cov_scaled += sigma[None, :, :]
    cov = cov_scaled * np.outer(scale, scale)[None, :, :]

    return {"central_value": mean, "cov": cov}


def predict(
    parameters: npt.NDArray[np.float64],
    emulation_config: EmulationConfig,
    merge_predictions_over_groups: bool = True,
    emulation_group_results: dict[str, dict[str, Any]] | None = None,
    emulator_cov_unexplained: dict[str, npt.NDArray] | None = None,
    slice_map: GroupSliceMap | None = None,
    scale_cov_unexplained_by_n_samples: bool = True,
) -> dict[str, Any]:
    """Merged emulator predictions over all groups (reference predict(), emulation.py:410-462)."""
    if emulation_group_results is None:
        emulation_group_results = emulation_config.read_all_emulator_groups()
    if emulator_cov_unexplained is None:
        emulator_cov_unexplained = compute_emulator_cov_unexplained(emulation_config, emulation_group_results)

    per_group = {
        name: predict_emulation_group(
            parameters,
            emulation_group_results[name],
            n_pc=cfg.n_pc,
            emulator_group_cov_unexplained=emulator_cov_unexplained[name],
            scale_cov_unexplained_by_n_samples=scale_cov_unexplained_by_n_samples,
        )
        for name, cfg in emulation_config.emulation_groups_config.items()
    }
    if not merge_predictions_over_groups:
        return per_group
    if slice_map is None:
        slice_map = GroupSliceMap.learn(emulation_config)
    return slice_map.merge(per_group)
