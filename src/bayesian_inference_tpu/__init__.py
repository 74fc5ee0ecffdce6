"""Bayesian inference of QCD transport properties in JAX.

A from-scratch JAX/XLA framework with the capabilities of
jdmulligan/bayesian-inference: design-point table ingest, outlier smoothing,
PCA reduction, Gaussian-process emulation, affine-invariant ensemble MCMC,
closure tests, and qhat(E,T) credible intervals -- with the numerical core
(PCA SVD, GP kernels/Cholesky/LML, MVN likelihood, stretch-move sampler)
running on an NVIDIA GPU, and on the CPU for tests.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Float32 matrix products run at full float32 precision ("float32", the
# same as "highest"). On a GPU, JAX's default for float32 products is TF32,
# which keeps a 10-bit mantissa: the GP predictive variance
# prior_var - k*^T K^-1 k* cancels badly at that precision, and on the H100
# the block-mode log-posterior of the final walkers then differs from a
# float64 evaluation by several nats (chip_smoke.py's precision study;
# PERF.md). Rounding of this class also flips marginally positive-definite
# covariance blocks negative. BIQ_MATMUL_PRECISION=default restores JAX's
# default; any other jax_default_matmul_precision value is accepted.
_precision = _os.environ.get("BIQ_MATMUL_PRECISION", "float32")
if _precision != "default":
    _jax.config.update("jax_default_matmul_precision", _precision)
