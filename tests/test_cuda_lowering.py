"""Lowering of the hot device programs for CUDA, on a host without a card.

jax's cross-platform lowering runs the Pallas->Triton IR generation on the
CPU host, so a kernel edit that Triton's lowering refuses, or a dispatch that
no longer selects the kernel on CUDA, fails here. What the GPU compiler makes
of the IR (registers, shared memory) shows only on the card:
``python chip_smoke.py``.

The programs are lowered in float32 (x64 off), their production dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

f32 = np.float32
_TRITON = "__gpu$xla.gpu.triton"


def _lower_cuda(traced) -> str:
    return traced.lower(lowering_platforms=("cuda",)).as_text()


def _make_likelihood(rng):
    from bayesian_inference_tpu.mcmc.likelihood import EmulatorLikelihood, GroupGPs
    from bayesian_inference_tpu.models.gp import GPPosterior
    from bayesian_inference_tpu.ops.gram import KernelConfig, KernelParams

    k, N, d = 5, 40, 6
    posts = GPPosterior(
        params=KernelParams(
            log_length_scale=jnp.asarray(rng.normal(size=(k, d)).astype(f32)),
            log_noise=jnp.asarray(rng.normal(size=(k,)).astype(f32)),
            log_constant=jnp.zeros((k,), jnp.float32),
        ),
        X=jnp.asarray(np.broadcast_to(rng.uniform(size=(N, d)).astype(f32), (k, N, d))),
        alpha=jnp.asarray(rng.normal(size=(k, N)).astype(f32)),
        Kinv=jnp.asarray(np.broadcast_to(np.eye(N, dtype=f32), (k, N, N))),
        prior_var=jnp.ones((k,), jnp.float32),
        lml=jnp.zeros((k,), jnp.float32),
    )
    U, D, d0 = [], [], []
    for nb, cnt in ((8, 3), (16, 4), (24, 2)):
        U.append(jnp.asarray(rng.normal(size=(cnt, nb, k)).astype(f32) * 0.1))
        D.append(jnp.asarray(np.broadcast_to(np.eye(nb, dtype=f32), (cnt, nb, nb))))
        d0.append(jnp.asarray(rng.normal(size=(cnt, nb)).astype(f32)))
    return EmulatorLikelihood(
        groups=(GroupGPs(cfg=KernelConfig(nu=1.5, with_noise=True), posts=posts),),
        theta_min=jnp.zeros((d,), jnp.float32),
        theta_max=jnp.ones((d,), jnp.float32),
        U=tuple(U), D=tuple(D), d0=tuple(d0), wb=None, mode="block",
    )


def _sampler_text(like, rng) -> str:
    from bayesian_inference_tpu.mcmc.stretch import init_state, run_chunk

    x0 = jnp.asarray(rng.uniform(0.2, 0.8, size=(100, 6)).astype(f32))

    def fn(aux, x):
        return aux.log_posterior(x)

    state = init_state.__wrapped__(jax.random.key(0), fn, x0, aux=like)
    return _lower_cuda(
        jax.jit(lambda st, aux: run_chunk(st, fn, 10, aux=aux)[1][2]).trace(state, like)
    )


def _block(rng):
    like = _make_likelihood(rng)
    return _sampler_text(like, rng), len(like.U)


def _lowrank(rng):
    from bayesian_inference_tpu.ops.mvn import build_woodbury

    like = _make_likelihood(rng)
    F = sum(int(np.prod(u.shape[:2])) for u in like.U)
    wb = build_woodbury(
        jnp.asarray(np.eye(F, dtype=f32)),
        jnp.asarray(rng.normal(size=(F, 5)).astype(f32) * 0.1),
        jnp.asarray(rng.normal(size=(F,)).astype(f32)),
    )
    return _sampler_text(like.replace(wb=wb, mode="lowrank"), rng), 0


def _closure_batch(rng):
    """The closure batch vmaps the sampler over P validation points, so the
    kernel lowers through the pallas batching rule (an extra grid dimension
    over the mapped d0 operand)."""
    from bayesian_inference_tpu.mcmc.stretch import init_state_batched, run_chunk_batched

    like = _make_likelihood(rng)
    P = 3
    d0_batch = tuple(
        jnp.asarray(rng.normal(size=(P,) + tuple(x.shape)).astype(f32)) for x in like.d0
    )
    x0 = jnp.asarray(rng.uniform(0.2, 0.8, size=(P, 100, 6)).astype(f32))
    keys = jax.random.split(jax.random.key(0), P)

    def fn(shared, d0_p, x):
        return shared.log_posterior_with_d0(d0_p, x)

    states = init_state_batched.__wrapped__(keys, fn, x0, d0_batch, shared_aux=like)
    text = _lower_cuda(
        jax.jit(
            lambda st, aux, shared: run_chunk_batched(st, fn, aux, 5, shared_aux=shared)[1][0]
        ).trace(states, d0_batch, like)
    )
    return text, len(like.U)


def _fit(rng):
    from bayesian_inference_tpu.models.gp_fit import _fit_gps_impl, spec_from_reference_config
    from bayesian_inference_tpu.ops.gram import KernelConfig

    N, d, k = 200, 6, 3  # N=200 exercises the 4-panel blocked path incl. padding
    texts = []
    for impl in ("autodiff", "matmul"):
        spec = spec_from_reference_config(
            KernelConfig(nu=1.5, with_noise=True),
            param_min=np.zeros(d), param_max=np.ones(d),
            n_restarts=2, n_iters=4, alpha_jitter=1e-6,
            dtype=jnp.float32, lml_impl=impl,
        )
        X = jnp.asarray(rng.uniform(size=(N, d)).astype(f32))
        Y = jnp.asarray(rng.normal(size=(N, k)).astype(f32))
        texts.append(_lower_cuda(
            jax.jit(lambda s, x, y, key: _fit_gps_impl(s, x, y, key)).trace(
                spec, X, Y, jax.random.key(0)
            )
        ))
    return "\n".join(texts), 0


@pytest.mark.parametrize("program", [_block, _lowrank, _closure_batch, _fit],
                         ids=["sampler_block", "sampler_lowrank", "closure_batch", "gp_fit"])
def test_hot_programs_lower_for_cuda(program):
    """Block-mode programs carry one fused MVN kernel per size bucket; the
    lowrank sampler and the fit are plain XLA (cuSOLVER/cuBLAS calls)."""
    with jax.enable_x64(False):
        text, n_kernels = program(np.random.default_rng(0))
    assert text.count(_TRITON) >= n_kernels
    if not n_kernels:
        assert _TRITON not in text
