"""Numerical kernels: Gram-matrix construction, batched Cholesky/MVN
log-likelihood (dense and Woodbury low-rank), and the fused block-MVN GPU
kernel of the MCMC hot loop (ops/pallas_mvn.py). These replace the
compiled-library calls the reference delegates to (sklearn kernels, LAPACK
dpotrf/dpotrs, emcee's core; see SURVEY.md section 2, "native-equivalent
components")."""

from bayesian_inference_tpu.ops.gram import (
    KernelConfig,
    KernelParams,
    cross_covariance,
    prior_variance,
    train_gram,
)
from bayesian_inference_tpu.ops.blocked_cholesky import blocked_chol_inv, chol_inv_batched
from bayesian_inference_tpu.ops.mvn import (
    WoodburyNormal,
    build_woodbury,
    mvn_loglike_dense,
    woodbury_loglike,
)

__all__ = [
    "KernelConfig",
    "KernelParams",
    "WoodburyNormal",
    "blocked_chol_inv",
    "build_woodbury",
    "chol_inv_batched",
    "cross_covariance",
    "mvn_loglike_dense",
    "prior_variance",
    "train_gram",
    "woodbury_loglike",
]
