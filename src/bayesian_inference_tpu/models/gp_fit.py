"""Multi-restart GP hyperparameter optimization, vmapped across PCs x restarts.

Replaces sklearn's per-PC loop of L-BFGS-B runs (reference emulation.py:169-172,
n_restarts_optimizer=50): every (principal component, restart) pair optimizes
simultaneously in ONE vmapped L-BFGS launch -- the device-batched answer to
the reference's "hot loop #2" (SURVEY.md section 3.2).

Bounded optimization: hyperparameters live in log space (as sklearn's
kernel.theta); box bounds are enforced by a sigmoid reparameterization
  theta_h = lo + (hi - lo) * sigmoid(u),
which matches L-BFGS-B interior optima exactly and approaches boundary optima
asymptotically. Restart initial points are uniform in the log-space box, as in
sklearn. Parity criterion: achieved LML >= sklearn's (we maximize the same
objective with many more effective restarts).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from bayesian_inference_tpu.utils import struct

from bayesian_inference_tpu.models.gp import (
    GPPosterior,
    log_marginal_likelihood_sqdiff,
    posterior_from_params,
)
from bayesian_inference_tpu.ops.gram import KernelConfig, KernelParams, pairwise_sqdiff


def pack_params(cfg: KernelConfig, params: KernelParams) -> jax.Array:
    """Flatten active hyperparameters to sklearn's kernel.theta ordering:
    [matern/rbf log length scales..., log constant?, log noise?]."""
    parts = [params.log_length_scale]
    if cfg.with_constant:
        parts.append(params.log_constant[None])
    if cfg.with_noise:
        parts.append(params.log_noise[None])
    return jnp.concatenate(parts)


def unpack_params(cfg: KernelConfig, flat: jax.Array, ndim: int) -> KernelParams:
    log_ls = flat[:ndim]
    i = ndim
    if cfg.with_constant:
        log_const = flat[i]
        i += 1
    else:
        log_const = jnp.zeros((), flat.dtype)
    log_noise = flat[i] if cfg.with_noise else jnp.zeros((), flat.dtype)
    return KernelParams(log_length_scale=log_ls, log_noise=log_noise, log_constant=log_const)


@struct.dataclass
class GPFitSpec:
    """Everything needed to fit the stack of per-PC GPs.

    Successive halving: every restart runs ``halving_iters`` L-BFGS iterations,
    then only the best ``halving_keep`` restarts per PC continue for the
    remaining ``n_iters - halving_iters`` (most random restarts land in bad
    basins; no point polishing them). Set halving_keep=0 to disable.
    Schedule choice is measured, not guessed: the CPU-x64 study
    (scripts/probe_fit_quality.py, docs/fit_schedule_study.json, 12 PCs x
    2 seeds at the production shape class) found keep=3 bit-equivalent to
    keep=4 (max |dLML| 4e-6 nats) while every cheaper halving point or
    iteration cut (h10/i45/i40 variants) loses 0.2-8 nats on some PC —
    hence keep=3, and the 15/60 iteration split stays.

    ``trial_steps``: step sizes along the L-BFGS direction evaluated per
    iteration (in ONE widened batch — see :func:`_optimize_single`). The
    batched LML value_and_grad is the entire fit cost, so the batch widening
    factor is a direct cost multiplier. CPU x64 studies on the fixture
    (2026-08-16/17, 12 PCs x 2 seeds x 21 restarts): (1.0,) reaches
    BIT-IDENTICAL final optima to (1.0, 0.1) and (1.0, 0.3, 0.1, 0.03) — the
    sigmoid box reparameterization keeps the preconditioned step well-scaled,
    and the running-best tracker makes an occasional overshoot harmless — so
    the default is the single full step at half the 2-trial fit cost.
    """

    cfg: KernelConfig
    theta0: jax.Array  # (P,)  initial log hyperparameters (sklearn's first run)
    log_lo: jax.Array  # (P,)  log-space lower bounds
    log_hi: jax.Array  # (P,)
    n_restarts: int = struct.field(pytree_node=False, default=50)
    n_iters: int = struct.field(pytree_node=False, default=100)
    alpha_jitter: float = struct.field(pytree_node=False, default=1e-10)
    halving_iters: int = struct.field(pytree_node=False, default=15)
    halving_keep: int = struct.field(pytree_node=False, default=3)
    # Multi-rung successive halving: ((iters_1, keep_1), (iters_2, keep_2), ...)
    # — run iters_1 L-BFGS iterations on the full restart pool, keep the best
    # keep_1 per PC, run iters_2 more, keep keep_2, ...; the remaining
    # n_iters - sum(iters_r) polish at full precision. Empty = derive a single
    # rung from halving_iters/halving_keep. The production default lives in
    # spec_from_reference_config and is study-gated like the single-rung
    # schedule (docs/fit_schedule_study.json).
    halving_schedule: tuple = struct.field(pytree_node=False, default=())
    trial_steps: tuple = struct.field(pytree_node=False, default=(1.0,))
    # LML implementation: "matmul" = blocked factorization with the
    # closed-form gradient (ops/blocked_cholesky + gp.log_marginal_likelihood
    # _matmul); "autodiff" = jnp.linalg.cholesky + AD backward. Value/grad
    # parity is pinned by tests/test_blocked_cholesky.py::
    # test_lml_matmul_matches_autodiff. "matmul" is the faster one on the
    # H100 (chip_smoke.py phase 4; PERF.md).
    lml_impl: str = struct.field(pytree_node=False, default="matmul")
    # Matmul precision for the EXPLORATION stage's factorization panels and
    # LML/gradient einsums ("highest" | "high" | "default"); "highest" keeps
    # full fidelity. BIQ_FIT_EXPLORE_CHOL overrides; the argument keys the
    # trace caches.
    explore_precision: str = struct.field(pytree_node=False, default="highest")


def _to_log_theta(spec: GPFitSpec, u: jax.Array) -> jax.Array:
    return spec.log_lo + (spec.log_hi - spec.log_lo) * jax.nn.sigmoid(u)


def _to_u(spec: GPFitSpec, log_theta: jax.Array) -> jax.Array:
    frac = (log_theta - spec.log_lo) / (spec.log_hi - spec.log_lo)
    frac = jnp.clip(frac, 1e-6, 1.0 - 1e-6)
    return jnp.log(frac) - jnp.log1p(-frac)


def _neg_lml_u(
    u: jax.Array, spec: GPFitSpec, D2: jax.Array, y: jax.Array, precision=None
) -> jax.Array:
    params = unpack_params(spec.cfg, _to_log_theta(spec, u), D2.shape[-1])
    if spec.lml_impl == "matmul":
        from bayesian_inference_tpu.models.gp import log_marginal_likelihood_matmul

        kw = {} if precision is None else {"precision": precision}
        lml = log_marginal_likelihood_matmul(
            spec.cfg, params, D2, y, spec.alpha_jitter, **kw
        )
    else:
        lml = log_marginal_likelihood_sqdiff(spec.cfg, params, D2, y, spec.alpha_jitter)
    # Guard non-finite (ill-conditioned gram at extreme hyperparams)
    return jnp.where(jnp.isfinite(lml), -lml, jnp.asarray(jnp.inf, lml.dtype))


def _optimize_single(
    u0: jax.Array,
    spec: GPFitSpec,
    D2: jax.Array,
    y: jax.Array,
    n_iters: int,
    precision=None,
) -> tuple[jax.Array, jax.Array]:
    """L-BFGS from one start; returns (best_u, best_neg_lml).

    Each iteration: the optax L-BFGS preconditioner produces a direction, then
    all ``spec.trial_steps`` candidates along it are evaluated (value AND
    grad) in one widened vmapped call — vs ~5 sequential value_and_grad
    chains for a masked backtracking loop under vmap; the lowest objective
    wins and its gradient seeds the next iteration. The running best is
    tracked so an occasional uphill move (all trials worse) cannot degrade
    the returned optimum — matching the multi-restart semantics where only
    the best basin matters (and making the default single full step safe;
    see GPFitSpec.trial_steps).
    """
    obj = partial(_neg_lml_u, spec=spec, D2=D2, y=y, precision=precision)
    precond = optax.scale_by_lbfgs(memory_size=8)
    state0 = precond.init(u0)
    steps = jnp.asarray(spec.trial_steps, u0.dtype)

    v0, g0 = jax.value_and_grad(obj)(u0)
    g0 = jnp.where(jnp.isfinite(g0), g0, 0.0)

    def step(carry, _):
        u, g, v, opt_state, best_u, best_v = carry
        # scale_by_lbfgs outputs P@g (to be SUBTRACTED: w' = w - s * P g); its
        # memory update uses the actual (params, grad) sequence we feed it, so
        # any trial step size keeps the curvature pairs consistent.
        direction, opt_state = precond.update(g, opt_state, u)
        cands = u[None, :] - steps[:, None] * direction[None, :]  # (K, P)
        vals, grads = jax.vmap(jax.value_and_grad(obj))(cands)    # (K,), (K, P)
        j = jnp.argmin(vals)
        u_n, v_n, g_n = cands[j], vals[j], grads[j]
        # All-trials-non-finite: stay put (best_u/best_v already hold the optimum).
        bad = ~jnp.isfinite(v_n)
        u_n = jnp.where(bad, u, u_n)
        v_n = jnp.where(bad, v, v_n)
        g_n = jnp.where(bad, g, g_n)
        g_n = jnp.where(jnp.isfinite(g_n), g_n, 0.0)
        improved = v_n < best_v
        best_u = jnp.where(improved, u_n, best_u)
        best_v = jnp.where(improved, v_n, best_v)
        return (u_n, g_n, v_n, opt_state, best_u, best_v), None

    (_, _, _, _, best_u, best_v), _ = jax.lax.scan(
        step, (u0, g0, v0, state0, u0, v0), None, length=n_iters
    )
    return best_u, best_v


def fit_gps(
    spec: GPFitSpec,
    X: jax.Array,
    Y_pc: jax.Array,
    key: jax.Array,
    mesh=None,
) -> GPPosterior:
    """Fit one GP per column of Y_pc (N, k); returns GPPosterior stacked on axis 0.

    For each PC: one run from spec.theta0 plus spec.n_restarts runs from
    uniform-in-log-bounds initial points; the best LML wins (sklearn semantics).
    All (PC, restart) instances optimize in one vmapped launch (ONE compiled
    program including the posterior build); with ``mesh`` the flattened
    instance axis is sharded across devices (each chip optimizes its share of
    restarts; the only collective is the final argmin gather).
    """
    return _fit_gps_impl(spec, X, Y_pc, key, mesh=mesh)


@partial(jax.jit, static_argnames=("mesh",))
def _fit_gps_impl(
    spec: GPFitSpec,
    X: jax.Array,
    Y_pc: jax.Array,
    key: jax.Array,
    mesh=None,
) -> GPPosterior:
    from bayesian_inference_tpu.parallel.mesh import shard_leading_axis

    N, k = Y_pc.shape
    P = spec.theta0.shape[0]
    R = spec.n_restarts + 1

    u0_first = _to_u(spec, spec.theta0)
    rand_logs = jax.random.uniform(
        key, (k, spec.n_restarts, P), dtype=spec.theta0.dtype,
        minval=spec.log_lo, maxval=spec.log_hi,
    )
    u0_rand = jax.vmap(jax.vmap(lambda lt: _to_u(spec, lt)))(rand_logs)
    u0 = jnp.concatenate([jnp.broadcast_to(u0_first, (k, 1, P)), u0_rand], axis=1)  # (k, R, P)

    # Flatten (PC, restart) -> instances so the batch shards evenly over a mesh.
    # Halving schedule: explicit multi-rung tuple, else a single rung from
    # halving_iters/halving_keep (the legacy spelling), else no halving.
    schedule = tuple(spec.halving_schedule)
    if not schedule and 0 < spec.halving_keep < R and spec.n_iters > spec.halving_iters:
        schedule = ((spec.halving_iters, spec.halving_keep),)
    # Drop degenerate rungs (keep >= current pool never prunes).
    pruned, pool = [], R
    for rung_iters, rung_keep in schedule:
        if 0 < rung_keep < pool:
            pruned.append((int(rung_iters), int(rung_keep)))
            pool = int(rung_keep)
    schedule = tuple(pruned)
    explore_iters = sum(it for it, _ in schedule)
    if schedule and explore_iters >= spec.n_iters:
        raise ValueError(
            f"halving schedule spends {explore_iters} iters, >= n_iters={spec.n_iters}"
        )

    D2 = pairwise_sqdiff(X)  # (N, N, d), shared by every fit instance

    # Exploration rungs: basin selection tolerates reduced matmul precision;
    # the survivors are re-polished at full float32.
    # The gram einsums follow the ambient default; the factorization panels +
    # LML/grad einsums run at spec.explore_precision (a STATIC argument so it
    # keys the trace caches — the polish stage below keeps the HIGHEST
    # default and never sees exploration-traced programs).
    from bayesian_inference_tpu.ops.blocked_cholesky import precision_from_name

    explore_p = precision_from_name(spec.explore_precision)
    pool_u, pool = u0, R  # (k, pool, P)
    if schedule:
        with jax.default_matmul_precision("default"):
            for rung_iters, rung_keep in schedule:
                u_flat = shard_leading_axis(pool_u.reshape(k * pool, P), mesh)
                y_flat = shard_leading_axis(jnp.repeat(Y_pc.T, pool, axis=0), mesh)
                u1, v1 = jax.vmap(
                    lambda u, y: _optimize_single(
                        u, spec, D2, y, rung_iters, precision=explore_p
                    )
                )(u_flat, y_flat)
                v1 = v1.reshape(k, pool)
                top = jnp.argsort(v1, axis=1)[:, :rung_keep]             # (k, keep)
                pool_u = jnp.take_along_axis(
                    u1.reshape(k, pool, P), top[:, :, None], axis=1
                )                                                        # (k, keep, P)
                pool = rung_keep
        # Polish: remaining iterations at full float32 on the survivors.
        u2_flat = shard_leading_axis(pool_u.reshape(k * pool, P), mesh)
        y2_flat = shard_leading_axis(jnp.repeat(Y_pc.T, pool, axis=0), mesh)
        u2, v2 = jax.vmap(
            lambda u, y: _optimize_single(u, spec, D2, y, spec.n_iters - explore_iters)
        )(u2_flat, y2_flat)
        best_u = u2.reshape(k, pool, P)
        best_v = v2.reshape(k, pool)
    else:
        u0_flat = shard_leading_axis(u0.reshape(k * R, P), mesh)
        y_flat = shard_leading_axis(jnp.repeat(Y_pc.T, R, axis=0), mesh)  # (k*R, N)
        with jax.default_matmul_precision("default"):
            u1_flat, v1_flat = jax.vmap(
                lambda u, y: _optimize_single(
                    u, spec, D2, y, spec.n_iters, precision=explore_p
                )
            )(u0_flat, y_flat)
        best_u = u1_flat.reshape(k, R, P)
        best_v = v1_flat.reshape(k, R)

    best_us = jnp.take_along_axis(
        best_u, jnp.argmin(best_v, axis=1)[:, None, None], axis=1
    )[:, 0, :]  # (k, P)

    def build(u: jax.Array, y: jax.Array) -> GPPosterior:
        params = unpack_params(spec.cfg, _to_log_theta(spec, u), X.shape[1])
        if spec.lml_impl == "matmul":
            from bayesian_inference_tpu.models.gp import posterior_from_params_matmul

            return posterior_from_params_matmul(spec.cfg, params, X, y, spec.alpha_jitter)
        return posterior_from_params(spec.cfg, params, X, y, spec.alpha_jitter)

    return jax.vmap(build)(best_us, Y_pc.T)


def spec_from_reference_config(
    cfg: KernelConfig,
    param_min,
    param_max,
    length_scale_bounds_factor=(0.01, 100.0),
    noise_level: float = 0.25,
    noise_level_bounds=(1e-4, 1.0),
    constant_value: float = 1.0,
    constant_value_bounds=(1e-3, 10.0),
    n_restarts: int = 50,
    n_iters: int = 100,
    alpha_jitter: float = 1e-10,
    dtype=jnp.float64,
    lml_impl: str | None = None,
) -> GPFitSpec:
    """Build a GPFitSpec with the reference's kernel initialization semantics
    (emulation.py:132-162): initial length scale = prior range (max - min),
    bounds = outer(range, factor). Host numpy math (eager device ops each
    compile a tiny remote program); leaves upload once at the jitted fit call.
    """
    import numpy as np

    np_dtype = np.dtype(jax.dtypes.canonicalize_dtype(dtype if dtype is not None else jnp.float64))
    ls0 = np.asarray(param_max, np.float64) - np.asarray(param_min, np.float64)
    lo_parts = [np.log(ls0 * length_scale_bounds_factor[0])]
    hi_parts = [np.log(ls0 * length_scale_bounds_factor[1])]
    theta0_parts = [np.log(ls0)]
    if cfg.with_constant:
        lo_parts.append(np.log([constant_value_bounds[0]]))
        hi_parts.append(np.log([constant_value_bounds[1]]))
        theta0_parts.append(np.log([constant_value]))
    if cfg.with_noise:
        lo_parts.append(np.log([noise_level_bounds[0]]))
        hi_parts.append(np.log([noise_level_bounds[1]]))
        theta0_parts.append(np.log([noise_level]))
    import os

    if lml_impl is None:
        # One default on every platform: the matmul implementation took
        # 6.95 ms per value+grad at B=2,091, N=195 on an H100 against 15.46 ms
        # for autodiff (chip_smoke.py phase 4; PERF.md). BIQ_FIT_LML overrides.
        lml_impl = os.environ.get("BIQ_FIT_LML") or "matmul"
    # Exploration-stage panel/LML precision: "highest" unless
    # BIQ_FIT_EXPLORE_CHOL overrides.
    explore_precision = os.environ.get("BIQ_FIT_EXPLORE_CHOL") or "highest"
    return GPFitSpec(
        cfg=cfg,
        theta0=np.concatenate(theta0_parts).astype(np_dtype),
        log_lo=np.concatenate(lo_parts).astype(np_dtype),
        log_hi=np.concatenate(hi_parts).astype(np_dtype),
        n_restarts=n_restarts,
        n_iters=n_iters,
        alpha_jitter=alpha_jitter,
        lml_impl=lml_impl,
        explore_precision=explore_precision,
    )
