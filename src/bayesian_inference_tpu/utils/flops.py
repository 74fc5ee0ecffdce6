"""Analytic FLOP accounting for the bench's utilization reporting.

The reference publishes no FLOP counts (its hot loops are hidden inside
sklearn/LAPACK/emcee — SURVEY.md §6); these counts are derived from this
framework's own program structure so bench.py can report
``flops_per_step`` / ``tflops_achieved`` / ``mfu`` instead of wall-clock
alone.

Counting conventions (documented so the numbers are auditable):

* one fused multiply-add = 2 FLOPs; matmul (m,k)x(k,n) = 2mkn.
* Counts follow the program structure (shared-sqdiff GP predict, bucketed
  block MVN, blocked matmul-only LML), not a textbook formula: the MVN
  covariance assembly is counted at the bucket widths (multiples of 8), and
  the Cholesky sweep at the rank-1-downdate op count. The CUDA kernel pads
  each bucket further, to a power of two (ops/pallas_mvn.kernel_tile); that
  padding is not counted. Elementwise transcendentals (exp/log/rsqrt in
  Matern and the sweep) are counted as 1 FLOP each.
* All counts are per *likelihood evaluation of W proposals*; one sampler
  step evaluates two half-ensembles of W/2, i.e. exactly W proposals/step.

Peak used for MFU: the card's dense bf16 tensor-core peak (the conventional
MFU denominator). This framework computes in float32, so the float32 and
TF32 peaks beside it bound what it could reach.
"""

from __future__ import annotations

from typing import Any

# Dense peaks of one card, by jax device_kind: NVIDIA H100 SXM data sheet,
# rates without sparsity. They assume the card's full 700 W power limit; a
# card set below it cannot hold its top clock under load (bench.py records
# the limit beside every number).
_PEAKS_BY_KIND = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
        "hbm_tbps": 3.35,
    },
}


def device_peaks(device=None) -> dict[str, float]:
    """Published peaks of the bench device; a device not in the table raises."""
    if device is None:
        import jax

        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    if kind not in _PEAKS_BY_KIND:
        raise KeyError(f"no published peaks for device_kind {kind!r}")
    return dict(_PEAKS_BY_KIND[kind])


def device_peak_tflops(device=None) -> float:
    """Dense bf16 peak of the bench device."""
    return device_peaks(device)["bf16_tflops"]


def _shape(x) -> tuple:
    return tuple(x.shape)


def mcmc_step_flops(like: Any, n_walkers: int) -> float:
    """FLOPs per sampler step (= per W-proposal likelihood evaluation).

    ``like`` is an EmulatorLikelihood or its ShapeDtypeStruct spec
    (mcmc/programs.likelihood_shape_spec) — only shapes are read.

    Components, per walker:
    * GP predict (models/gp.predict_all_shared), per group of k stacked PCs
      over N design points in d dims: cross-kernel rows k*N*(3d+8)
      (d sub/mul/add per sqdiff dim + ~8 for the Matern polynomial*exp),
      posterior mean ks@alpha 2kN, variance ks@Kinv 2kN^2 + row-dot 2kN.
      The k_total x W x N^2 variance einsum dominates the whole step.
    * Block MVN (ops/pallas_mvn), per bucket (n_obs, nb, k) with
      k1 = k_total + 1 (the d0 offset counted as one more column): residual
      2*nb*k1, covariance assembly 2*nb^2*k1, Cholesky sweep ~nb^3 (rank-1
      downdates: sum_j 2*(nb-j)*nb) + forward solve/logdet ~4*nb^2.
    """
    W = float(n_walkers)
    total = 0.0
    for g in like.groups:
        k, N, d = _shape(g.posts.X)
        total += W * k * N * (3 * d + 8)          # kernel rows
        total += W * 2 * k * N                    # mean ks@alpha
        total += W * 2 * k * N * N                # var ks@Kinv
        total += W * 2 * k * N                    # var row-dot
    if getattr(like, "mode", "block") == "lowrank":
        # Woodbury route (ops/mvn.woodbury_loglike): one k x k capacitance
        # system per walker — M assembly ~k^2, r = G@z 2k^2, the Cholesky
        # and solve (counted as two k^3 + 4k^2 sweeps), plus the
        # z-quadratics (~2k^2).
        k = _shape(like.wb.G)[0]
        total += W * (5 * k * k + 2 * (k**3 + 4 * k * k))
        return total
    for U in like.U:
        n_obs, nb, k = _shape(U)
        k1 = k + 1
        per_walker = n_obs * (
            2 * nb * k1                            # residual U@z
            + 2 * nb * nb * k1                     # covariance assembly
            + nb**3                                # rank-1 downdate sweep
            + 4 * nb * nb                          # fwd solve + quad/logdet
        )
        total += W * per_walker
    return total


def fit_iteration_flops(N: int, d: int, n_hyper: int | None = None) -> float:
    """FLOPs of ONE LML value+grad evaluation for one (PC, restart) instance.

    Follows models/gp.log_marginal_likelihood_matmul + _lml_matmul_bwd:
    gram (weighted sqdiff contraction 2N^2 d + Matern ~8N^2), blocked
    Cholesky N^3/3 + triangular inverse N^3/3, alpha two matvecs 4N^2,
    backward: Kinv = invL^T invL 2N^3(!), G/H ~4N^2, d(log ls) contraction
    2N^2 d, traces ~2N^2.
    """
    if n_hyper is None:
        n_hyper = d + 2
    return (
        2 * N**2 * d + 8 * N**2            # gram
        + N**3 / 3 + N**3 / 3              # chol + inv(L)
        + 4 * N**2                         # alpha
        + 2 * N**3                         # Kinv (backward)
        + 4 * N**2 + 2 * N**2 * d + 2 * N**2  # grad contractions
    )


def fit_total_flops(
    N: int, d: int, k_pcs: int, n_restarts: int,
    n_iters: int, halving_iters: int = 15, halving_keep: int = 4,
) -> float:
    """Total fit FLOPs for the vmapped multi-restart schedule
    (models/gp_fit._fit_gps_impl): R = n_restarts+1 instances per PC run
    halving_iters(+1 seed eval) iterations, the top halving_keep continue
    for the remainder, then one posterior build (~3N^3) per PC."""
    R = n_restarts + 1
    per_iter = fit_iteration_flops(N, d)
    halve = 0 < halving_keep < R and n_iters > halving_iters
    iters1 = halving_iters if halve else n_iters
    total = k_pcs * R * (iters1 + 1) * per_iter
    if halve:
        total += k_pcs * halving_keep * (n_iters - halving_iters) * per_iter
    total += k_pcs * 3 * N**3  # posterior build (chol + Kinv + alpha)
    return total
