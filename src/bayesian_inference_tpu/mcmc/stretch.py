"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move),
implemented as a vmapped two-half update inside a single ``lax.scan``.

Replaces emcee's EnsembleSampler + the reference's multiprocessing pool
(mcmc.py:72-107): the ENTIRE chain — proposal, batched GP-emulated likelihood,
accept/reject — runs on-chip with zero host round-trips.

Semantics follow emcee's StretchMove:
  - ensemble split into two halves; with ``randomize_split`` the walker order
    is shuffled every iteration (emcee RedBlueMove default)
  - for each walker in the half being updated: partner X_c drawn uniformly
    from the complementary half; z ~ g(z) with density ∝ 1/sqrt(z) on
    [1/a, a] via z = ((a-1)u + 1)^2 / a; proposal Y = X_c + z (X - X_c)
  - accept with log-probability min(0, (d-1) log z + logp(Y) - logp(X))
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class EnsembleState(NamedTuple):
    coords: jax.Array     # (W, d)
    log_prob: jax.Array   # (W,)
    n_accepted: jax.Array # (W,) int32
    key: jax.Array


def _stretch_half_draws(
    u: jax.Array,
    partners: jax.Array,
    u_acc: jax.Array,
    x_upd: jax.Array,
    logp_upd: jax.Array,
    x_comp: jax.Array,
    log_prob_fn: Callable[[jax.Array], jax.Array],
    a: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One half-update from PREGENERATED draws (u, partners, u_acc).

    Factoring the draws out lets run_chunk hoist all RNG work out of the scan
    body (see _pregen_rands), so the step holds only the move and the
    likelihood."""
    d = x_upd.shape[1]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    x_c = x_comp[partners]
    y = x_c + z[:, None] * (x_upd - x_c)

    logp_y = log_prob_fn(y)
    log_ratio = (d - 1.0) * jnp.log(z) + logp_y - logp_upd
    accept = jnp.log(u_acc) < log_ratio

    x_new = jnp.where(accept[:, None], y, x_upd)
    logp_new = jnp.where(accept, logp_y, logp_upd)
    return x_new, logp_new, accept


def _stretch_half(
    key: jax.Array,
    x_upd: jax.Array,
    logp_upd: jax.Array,
    x_comp: jax.Array,
    log_prob_fn: Callable[[jax.Array], jax.Array],
    a: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Update one half against the complementary half. Returns (x, logp, accepted)."""
    n, _ = x_upd.shape
    k_z, k_pair, k_acc = jax.random.split(key, 3)
    u = jax.random.uniform(k_z, (n,), dtype=x_upd.dtype)
    partners = jax.random.randint(k_pair, (n,), 0, x_comp.shape[0])
    u_acc = jax.random.uniform(k_acc, (n,), dtype=x_upd.dtype)
    return _stretch_half_draws(u, partners, u_acc, x_upd, logp_upd, x_comp, log_prob_fn, a)


def _pregen_rands(key: jax.Array, n: int, W: int, dtype, randomize_split: bool):
    """Hoisted per-step randomness for ``n`` ensemble steps, as scan inputs.

    Derives EVERY draw the stretch move needs from ``key`` in a handful of
    batched threefry calls — instead of per-step key splits + draws inside
    the scan body, where each small op adds its own launch to every step.
    The stream differs from the per-step-split scheme but is
    equally deterministic: chunk k+1's draws derive from ``fold_in(key, 4)``
    so successive chunks never reuse a stream, and resume reproduces the
    uninterrupted run bit-exactly as long as dispatch-chunk boundaries align
    (the runner's checkpoints are per-chunk, so they always do).

    Returns (per-step pytree of draws, next_key). Permutations come from an
    argsort over int32 draws — a tie (p ~ W^2/2^33 per step) degrades to
    index order for the tied pair, statistically immaterial.
    """
    half = W // 2
    sub = lambda c: jax.random.fold_in(key, c)
    if randomize_split:
        bits = jax.random.randint(
            sub(0), (n, W), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max
        )
        perm = jnp.argsort(bits, axis=-1)
        inv = jnp.argsort(perm, axis=-1)
    else:
        perm = inv = jnp.broadcast_to(jnp.arange(W), (n, W))
    rands = {
        "perm": perm,
        "inv": inv,
        "u_z": jax.random.uniform(sub(1), (n, 2, half), dtype=dtype),
        "partners": jax.random.randint(sub(2), (n, 2, half), 0, half),
        "u_acc": jax.random.uniform(sub(3), (n, 2, half), dtype=dtype),
    }
    return rands, sub(4)


def _step_with_rands(
    state: EnsembleState,
    rands,
    log_prob_fn: Callable[[jax.Array], jax.Array],
    a: float = 2.0,
) -> EnsembleState:
    """One full ensemble step consuming one step's slice of _pregen_rands.

    The carried key is untouched — run_chunk advances it once per chunk."""
    half = state.coords.shape[0] // 2
    x = state.coords[rands["perm"]]
    logp = state.log_prob[rands["perm"]]
    inv = rands["inv"]

    x0, lp0, a0 = _stretch_half_draws(
        rands["u_z"][0], rands["partners"][0], rands["u_acc"][0],
        x[:half], logp[:half], x[half:], log_prob_fn, a,
    )
    x1, lp1, a1 = _stretch_half_draws(
        rands["u_z"][1], rands["partners"][1], rands["u_acc"][1],
        x[half:], logp[half:], x0, log_prob_fn, a,
    )

    x_new = jnp.concatenate([x0, x1], axis=0)[inv]
    logp_new = jnp.concatenate([lp0, lp1], axis=0)[inv]
    acc_new = jnp.concatenate([a0, a1], axis=0)[inv]

    return EnsembleState(
        coords=x_new,
        log_prob=logp_new,
        n_accepted=state.n_accepted + acc_new.astype(jnp.int32),
        key=state.key,
    )


def step(
    state: EnsembleState,
    log_prob_fn: Callable[[jax.Array], jax.Array],
    a: float = 2.0,
    randomize_split: bool = True,
) -> EnsembleState:
    """One full ensemble step (both halves updated)."""
    W = state.coords.shape[0]
    half = W // 2
    key, k_perm, k_h0, k_h1 = jax.random.split(state.key, 4)

    if randomize_split:
        perm = jax.random.permutation(k_perm, W)
    else:
        perm = jnp.arange(W)
    inv = jnp.argsort(perm)

    x = state.coords[perm]
    logp = state.log_prob[perm]

    # Build the updated permuted ensemble by concatenation (no scatter): the
    # second half's complementary set is exactly the freshly updated first
    # half. (A previous formulation using x.at[:half].set(...) + final gather
    # was miscompiled under jit on CPU — coords/logp lost alignment.)
    x0, lp0, a0 = _stretch_half(k_h0, x[:half], logp[:half], x[half:], log_prob_fn, a)
    x1, lp1, a1 = _stretch_half(k_h1, x[half:], logp[half:], x0, log_prob_fn, a)

    x_new = jnp.concatenate([x0, x1], axis=0)[inv]
    logp_new = jnp.concatenate([lp0, lp1], axis=0)[inv]
    acc_new = jnp.concatenate([a0, a1], axis=0)[inv]

    return EnsembleState(
        coords=x_new,
        log_prob=logp_new,
        n_accepted=state.n_accepted + acc_new.astype(jnp.int32),
        key=key,
    )


@partial(jax.jit, static_argnames=("log_prob_fn",))
def init_state(key: jax.Array, log_prob_fn, x0: jax.Array, aux=None) -> EnsembleState:
    """Evaluate the initial ensemble log-probabilities and zero the counters.

    ``aux``: optional pytree of runtime operands for the log-probability. When
    given, ``log_prob_fn(aux, x)`` is called instead of ``log_prob_fn(x)``.
    Passing model state as an operand (rather than closing over it) keeps the
    compiled program value-independent, so the persistent compilation cache
    hits across runs whose fitted emulators differ, and the program can be
    AOT-compiled from shape specs before the fit exists (mcmc/programs.py).
    """
    fn = log_prob_fn if aux is None else (lambda x: log_prob_fn(aux, x))
    return EnsembleState(
        coords=x0,
        log_prob=fn(x0),
        n_accepted=jnp.zeros(x0.shape[0], jnp.int32),
        key=key,
    )


@partial(jax.jit, static_argnames=("log_prob_fn", "n_steps", "a", "randomize_split", "store_chain", "thin"))
def run_chunk(
    state: EnsembleState,
    log_prob_fn: Callable[[jax.Array], jax.Array],
    n_steps: int,
    a: float = 2.0,
    randomize_split: bool = True,
    store_chain: bool = True,
    thin: int = 1,
    aux=None,
):
    """Advance the ensemble by n_steps in one compiled lax.scan program.

    Chunks with identical static arguments share ONE compiled executable, so
    burn-in phases and production dispatch the same program, and each
    distinct scan program is compiled once.
    ``aux`` is an optional runtime-operand pytree (see init_state).

    Returns (final_state, ys) with ys = (coords, log_prob, mean_accept) per
    step when store_chain, else a per-step mean-acceptance trace only. The
    scalar trace costs one float per step and lets the host log the
    reference's ``n_logging_steps`` acceptance cadence (mcmc.py:187-204)
    without chunking the dispatch.

    RNG: all per-step draws are HOISTED out of the scan into batched
    pregeneration (_pregen_rands) — the scan body contains no key splits,
    draws, or permutation sorts, only the move itself and the likelihood.
    ``BIQ_RNG_HOIST=0`` reverts to the per-step-split stream (A/B; read at
    trace time, so it must be set before the first run_chunk trace).
    """
    import os as _os

    fn = log_prob_fn if aux is None else (lambda x: log_prob_fn(aux, x))

    if _os.environ.get("BIQ_RNG_HOIST", "1") != "0":
        W = state.coords.shape[0]
        rands, next_key = _pregen_rands(
            state.key, n_steps, W, state.coords.dtype, randomize_split
        )
        if thin > 1:
            rands = jax.tree.map(
                lambda r: r.reshape(n_steps // thin, thin, *r.shape[1:]), rands
            )

        def body(s, r):
            new = s
            for t in range(thin):
                rt = jax.tree.map(lambda x: x[t], r) if thin > 1 else r
                new = _step_with_rands(new, rt, fn, a=a)
            acc = jnp.mean((new.n_accepted - s.n_accepted).astype(new.coords.dtype))
            out = (new.coords, new.log_prob, acc) if store_chain else acc
            return new, out

        final, ys = jax.lax.scan(body, state, rands, length=n_steps // thin)
        return final._replace(key=next_key), ys

    def body(s, _):
        new = s
        for _ in range(thin):
            new = step(new, fn, a=a, randomize_split=randomize_split)
        acc = jnp.mean((new.n_accepted - s.n_accepted).astype(new.coords.dtype))
        out = (new.coords, new.log_prob, acc) if store_chain else acc
        return new, out

    final, ys = jax.lax.scan(body, state, None, length=n_steps // thin)
    return final, ys


# --------------------------------------------------------------------------------------
# Batched ensembles: P independent samplers advanced in ONE compiled program.
#
# Used by the closure-test stage: the only per-point difference is an auxiliary
# likelihood operand (the pseudodata residual offset), so all validation-point
# MCMCs vmap into a single scan, in place of the reference's
# sequential closure loop (steer_analysis.py:174-181).
# --------------------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("log_prob_fn",))
def init_state_batched(keys: jax.Array, log_prob_fn, x0: jax.Array, aux, shared_aux=None) -> EnsembleState:
    """Vmapped init: keys (P,), x0 (P, W, d), aux pytree with leading P axis.

    ``log_prob_fn(aux_p, x)`` maps one point's auxiliary operand and a (W, d)
    walker batch to (W,) log-posteriors. With ``shared_aux`` (a pytree WITHOUT
    a P axis, broadcast to every point — e.g. the likelihood state), the call
    is ``log_prob_fn(shared_aux, aux_p, x)``; passing the model as an operand
    keeps the compiled program value-independent (see mcmc/programs.py).
    """
    def one(key, x, a):
        if shared_aux is None:
            return init_state(key, lambda xx: log_prob_fn(a, xx), x)
        return init_state(key, lambda xx: log_prob_fn(shared_aux, a, xx), x)

    return jax.vmap(one)(keys, x0, aux)


@partial(jax.jit, static_argnames=("log_prob_fn", "n_steps", "a", "randomize_split", "store_chain", "thin"))
def run_chunk_batched(
    states: EnsembleState,
    log_prob_fn,
    aux,
    n_steps: int,
    a: float = 2.0,
    randomize_split: bool = True,
    store_chain: bool = True,
    thin: int = 1,
    shared_aux=None,
):
    """Advance P independent ensembles by n_steps in one compiled lax.scan.

    ``states`` is an EnsembleState pytree with a leading P axis on every leaf;
    ``aux`` is the per-point likelihood operand (leading P axis) and
    ``shared_aux`` an optional P-invariant operand pytree (see
    init_state_batched). The chain output has shape (n_steps//thin, P, W, d).

    RNG is hoisted out of the scan exactly as in run_chunk (one batched
    pregeneration per point, vmapped); BIQ_RNG_HOIST=0 reverts.
    """
    import os as _os

    if _os.environ.get("BIQ_RNG_HOIST", "1") != "0":
        W = states.coords.shape[1]
        dtype = states.coords.dtype

        rands, next_keys = jax.vmap(
            lambda k: _pregen_rands(k, n_steps, W, dtype, randomize_split)
        )(states.key)
        # (P, n, ...) -> scan-major (n, P, ...), then fold thin substeps
        rands = jax.tree.map(lambda r: jnp.moveaxis(r, 0, 1), rands)
        if thin > 1:
            rands = jax.tree.map(
                lambda r: r.reshape(n_steps // thin, thin, *r.shape[1:]), rands
            )

        def step_point_r(s, aux_p, r):
            fn = (lambda x: log_prob_fn(aux_p, x)) if shared_aux is None else (
                lambda x: log_prob_fn(shared_aux, aux_p, x)
            )
            new = s
            for t in range(thin):
                rt = jax.tree.map(lambda x: x[t], r) if thin > 1 else r
                new = _step_with_rands(new, rt, fn, a=a)
            return new

        vstep_r = jax.vmap(step_point_r, in_axes=(0, 0, 1 if thin > 1 else 0))

        def body(s, r):
            # r leaves: (thin, P, ...) when thin>1 else (P, ...)
            new = vstep_r(s, aux, r)
            out = (new.coords, new.log_prob) if store_chain else None
            return new, out

        final, ys = jax.lax.scan(body, states, rands, length=n_steps // thin)
        return final._replace(key=next_keys), ys

    def step_point(s, aux_p):
        fn = (lambda x: log_prob_fn(aux_p, x)) if shared_aux is None else (
            lambda x: log_prob_fn(shared_aux, aux_p, x)
        )
        new = s
        for _ in range(thin):
            new = step(new, fn, a=a, randomize_split=randomize_split)
        return new

    vstep = jax.vmap(step_point)

    def body(s, _):
        new = vstep(s, aux)
        out = (new.coords, new.log_prob) if store_chain else None
        return new, out

    final, ys = jax.lax.scan(body, states, None, length=n_steps // thin)
    return final, ys


def run_ensemble(
    key: jax.Array,
    log_prob_fn: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    n_steps: int,
    a: float = 2.0,
    randomize_split: bool = True,
    store_chain: bool = True,
    thin: int = 1,
    chunk_size: int | None = None,
    aux=None,
) -> dict[str, jax.Array]:
    """Run the sampler for ``n_steps`` on-chip.

    ``chunk_size`` splits the run into multiple dispatches of one shared
    compiled program (must divide n_steps); None = single dispatch.

    Returns {'chain': (n_steps//thin, W, d) [if store_chain], 'log_prob': same
    leading shape, 'acceptance_trace' (per-step mean acceptance), 'coords',
    'final_log_prob', 'acceptance_fraction', 'key'}.
    """
    W = x0.shape[0]
    if W % 2:
        raise ValueError("n_walkers must be even")
    if chunk_size is None:
        chunk_size = n_steps
    if n_steps % chunk_size:
        raise ValueError(f"chunk_size {chunk_size} must divide n_steps {n_steps}")

    state = init_state(key, log_prob_fn, x0, aux=aux)
    chains, logps, accs = [], [], []
    for _ in range(n_steps // chunk_size):
        state, ys = run_chunk(
            state, log_prob_fn, chunk_size, a=a,
            randomize_split=randomize_split, store_chain=store_chain, thin=thin,
            aux=aux,
        )
        if store_chain:
            chains.append(ys[0])
            logps.append(ys[1])
            accs.append(ys[2])
        else:
            accs.append(ys)

    result = {
        "coords": state.coords,
        "final_log_prob": state.log_prob,
        "acceptance_fraction": state.n_accepted.astype(x0.dtype) / n_steps,
        "acceptance_trace": accs[0] if len(accs) == 1 else jnp.concatenate(accs, axis=0),
        "key": state.key,
    }
    if store_chain:
        result["chain"] = chains[0] if len(chains) == 1 else jnp.concatenate(chains, axis=0)
        result["log_prob"] = logps[0] if len(logps) == 1 else jnp.concatenate(logps, axis=0)
    return result
