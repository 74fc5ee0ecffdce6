"""k-fold cross-validation of the GP emulators.

The reference declares this but never builds it (config
jet_substructure.yaml:85-90: ``cross_validation: False`` /
``cross_validation_k: 5`` under a "TODO: Cross-validation" comment). Here it
is implemented on the device: each fold's multi-restart GP fit is the same
fully vmapped single-launch program the production fit uses
(models/gp_fit.py), so a full k-fold pass costs k fused fits.

Per fold: scaler+PCA and GP hyperparameters are refit on the k-1 training
folds only (no leakage), the held-out design points are emulated, and
residuals are standardized by the emulator's own predictive uncertainty
(GP variance propagated through the PC basis + truncation covariance
diagonal — the same uncertainty model the MCMC likelihood uses).

Artifact: ``cross_validation_<group>.h5`` with per-point predictions, truth,
predictive std, fold assignments, and summary metrics. Well-calibrated
emulators give standardized residuals ~ N(0, 1); plots/emulation.py renders
the histogram when the artifact exists.
"""

from __future__ import annotations

import logging
from typing import Any

import jax
import numpy as np

from bayesian_inference_tpu.io import observables as obs_io
from bayesian_inference_tpu.models import gp as gp_mod
from bayesian_inference_tpu.models import gp_fit
from bayesian_inference_tpu.models import pca as pca_mod

logger = logging.getLogger(__name__)


def cross_validate_group(
    group_config,
    k: int | None = None,
    seed: int = 0,
    n_opt_iters: int = 60,
) -> dict[str, Any]:
    """k-fold CV for one emulation group; returns the artifact dict.

    Design points are shuffled (seeded) and split into k equal folds; a
    remainder of ``n mod k`` points is left out of every test fold (but always
    trains) so every fold's fit shares one compiled program shape.
    """
    if k is None:
        k = getattr(group_config, "cross_validation_k", 5)
    Y = obs_io.predictions_matrix_from_h5(
        group_config.output_dir,
        filename=group_config.observables_filename,
        observable_filter=group_config.observable_filter,
    )
    design = np.asarray(
        obs_io.design_array_from_h5(
            group_config.output_dir, filename=group_config.observables_filename
        ),
        float,
    )
    n, F = Y.shape
    if k < 2 or k > n // 2:
        raise ValueError(f"cross_validation_k={k} invalid for {n} design points")
    fold_size = n // k
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = perm[: fold_size * k].reshape(k, fold_size)
    n_pc = group_config.n_pc

    preds = np.zeros((k, fold_size, F))
    stds = np.zeros((k, fold_size, F))
    truth = np.zeros((k, fold_size, F))
    lml = np.zeros((k, n_pc))

    for f in range(k):
        test_idx = folds[f]
        train_idx = np.setdiff1d(perm, test_idx)
        state, Y_pca = pca_mod.fit_pca(
            Y[train_idx], max_n_components=group_config.max_n_components_to_calculate
        )
        Ypc_train = np.asarray(Y_pca[:, :n_pc])
        spec = group_config.fit_spec(n_iters=n_opt_iters)
        X_train = np.asarray(design[train_idx], Ypc_train.dtype)
        posts = gp_fit.fit_gps(
            spec, jax.numpy.asarray(X_train), Ypc_train, jax.random.key(seed + f)
        )

        cfg = group_config.kernel_config()
        theta = jax.numpy.asarray(np.asarray(design[test_idx], Ypc_train.dtype))
        z, v = gp_mod.predict_all_jit(cfg, posts, theta)
        z, v = np.asarray(z, float), np.asarray(v, float)

        S_k = np.asarray(state.components[:n_pc], float)     # (n_pc, F)
        scale = np.asarray(state.scale, float)
        preds[f] = np.asarray(state.unscale_features(z @ S_k))
        # Predictive variance in physical space: GP variance through the PC
        # basis + the truncation covariance diagonal (undivided per-point form,
        # same as the MCMC likelihood — models/emulator.py docstring).
        trunc_diag = np.asarray(
            np.diag(np.asarray(pca_mod.truncation_covariance(state, n_pc), float))
        )
        var_scaled = v @ (S_k**2) + trunc_diag[None, :]
        stds[f] = np.sqrt(var_scaled) * scale[None, :]
        truth[f] = Y[test_idx]
        lml[f] = np.asarray(posts.lml)

    resid = preds - truth
    zscores = resid / np.where(stds > 0, stds, np.inf)
    artifact = {
        "fold_indices": folds,
        "predictions": preds,
        "truth": truth,
        "predictive_std": stds,
        "normalized_residuals": zscores,
        "rmse_per_feature": np.sqrt(np.mean(resid.reshape(-1, F) ** 2, axis=0)),
        "lml_per_fold": lml,
        "k": np.asarray(k),
        "seed": np.asarray(seed),
    }
    z_flat = zscores.ravel()
    logger.info(
        f"CV[{getattr(group_config, 'group_name', '?')}]: k={k}, "
        f"RMSE median {np.median(artifact['rmse_per_feature']):.4g}, "
        f"|z| mean {np.abs(z_flat).mean():.3f} (1sigma coverage "
        f"{(np.abs(z_flat) < 1).mean():.2f}, want ~0.68)"
    )
    return artifact


def cross_validate(emulation_config, seed: int = 0, n_opt_iters: int = 60) -> dict[str, Any]:
    """CV for every group with ``cross_validation: true``; writes artifacts."""
    import os

    from bayesian_inference_tpu.io import hdf5

    out: dict[str, Any] = {}
    for name, group_config in emulation_config.emulation_groups_config.items():
        if not getattr(group_config, "cross_validation", False):
            continue
        artifact = cross_validate_group(group_config, seed=seed, n_opt_iters=n_opt_iters)
        filename = f"cross_validation_{name}.h5"
        hdf5.write_dict_to_h5(artifact, group_config.output_dir, filename, verbose=False)
        logger.info(f"Wrote {os.path.join(group_config.output_dir, filename)}")
        out[name] = artifact
    return out
