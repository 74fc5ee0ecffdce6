"""Posterior statistics: credible intervals, MAP estimate, autocorrelation time.

Host-side numpy diagnostics (reference mcmc.py:137-184 and emcee's FFT-based
integrated autocorrelation time, used at plot_mcmc.py:185,198).
"""

from __future__ import annotations

import numpy as np
import numpy.typing as npt


def credible_interval(samples: npt.NDArray, confidence: float = 0.9, interval_type: str = "quantile"):
    """Credible interval of a 1-D sample array: 'hpd' (minimum width) or 'quantile'."""
    samples = np.asarray(samples)
    if interval_type == "hpd":
        nci = int((1 - confidence) * samples.size)
        argp = np.argpartition(samples, [nci, samples.size - nci])
        lows = np.sort(samples[argp[:nci]])
        highs = np.sort(samples[argp[-nci:]])
        i = np.argmin(highs - lows)
        return lows[i], highs[i]
    if interval_type == "quantile":
        lo = (1 - confidence) / 2
        return tuple(np.quantile(samples, [lo, 1 - lo]))
    raise ValueError(f"Unknown interval_type {interval_type}")


def map_parameters(posterior: npt.NDArray, method: str = "quantile") -> npt.NDArray:
    """MAP estimate: mean of samples inside a narrow central quantile band, per dim."""
    if method != "quantile":
        raise ValueError(f"Unknown method {method}")
    posterior = np.asarray(posterior)
    q = 0.01
    lo = np.quantile(posterior, 0.5 - q / 2, axis=0)
    hi = np.quantile(posterior, 0.5 + q / 2, axis=0)
    mask = (posterior >= lo) & (posterior <= hi)
    return np.array([posterior[mask[:, i], i].mean() for i in range(posterior.shape[1])])


# --------------------------------------------------------------------------------------
# Integrated autocorrelation time (Goodman & Weare / Sokal windowing, as in emcee)
# --------------------------------------------------------------------------------------

class AutocorrError(Exception):
    """Chain too short to reliably estimate the autocorrelation time."""


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function_1d(x: npt.NDArray) -> npt.NDArray:
    """Normalized autocorrelation function of a 1-D series via FFT."""
    x = np.atleast_1d(np.asarray(x, float))
    n = _next_pow_two(len(x))
    f = np.fft.fft(x - np.mean(x), n=2 * n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    return acf / acf[0]


def _auto_window(taus: npt.NDArray, c: float) -> int:
    m = np.arange(len(taus)) < c * taus
    if np.any(m):
        return int(np.argmin(m))
    return len(taus) - 1


# Truncated-lag ACF: Sokal's window for any chain passing the tol=50
# reliability bar sits at <= c * n_t/tol ~ n_t/10 lags, so computing the
# exact linear ACF only out to lag L (FFT length next_fast_len(n_t + L - 1)
# instead of next_fast_len(2*n_t - 1)) loses nothing and cuts the forward
# transforms ~1.7x at production chain lengths. Lags < L are EXACT (circular
# wrap only touches lags > nfft - n_t >= L - 1); when the window does not
# converge within L the caller falls back to the full-length transform.
# Detection: m[0] = (0 < c*taus[0]) = (0 < c) is always True, so
# _auto_window's argmin can only return 0 when m is all-True, i.e. no window
# was found in range. BIQ_ACF_MAX_LAG overrides (0 = always full length).
_ACF_MAX_LAG = 8192


def _acf_lag_cap(n_t: int) -> int:
    """Effective ACF lag cap for an n_t-step chain: full length unless the
    chain is long enough (>= 2x the cap) for truncation to pay for itself."""
    import os

    cap = int(os.environ.get("BIQ_ACF_MAX_LAG", _ACF_MAX_LAG) or 0)
    if 0 < cap and n_t >= 2 * cap:
        return cap
    return n_t


def split_rhat(chain: npt.NDArray) -> npt.NDArray:
    """Split-chain Gelman-Rubin potential-scale-reduction factor per parameter.

    Neither the reference nor emcee reports R-hat; it is the standard
    complementary convergence check to the integrated autocorrelation time
    (Gelman et al., BDA3 eq. 11.4: each walker's chain is split in half, and
    between- vs within-half variances are compared). Values near 1 indicate
    the halves are indistinguishable; > ~1.01-1.1 flags non-convergence.

    ``chain``: (n_steps, n_walkers, ndim). Returns (ndim,).
    """
    chain = np.asarray(chain)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t = chain.shape[0] - (chain.shape[0] % 2)
    half = n_t // 2
    # Each walker contributes two half-chains. Statistics come from two
    # single-pass f64-accumulated moment reductions per half over the GLOBALLY
    # centered chain (centering kills the s2 - n*mu^2 cancellation) — no
    # (2W, half, d) transpose copy and no multi-GB f64 delta temps; this runs
    # on the hot bench path right after the chain download.
    c = chain[:n_t] - chain[:n_t].mean(axis=(0, 1), dtype=np.float64).astype(chain.dtype)
    n = half
    means_parts, s2_parts = [], []
    for p in (c[:half], c[half:]):
        means_parts.append(p.sum(axis=0, dtype=np.float64) / n)          # (W, d)
        s2_parts.append(np.einsum("twd,twd->wd", p, p, dtype=np.float64))
    means = np.concatenate(means_parts, axis=0)                          # (2W, d)
    s2 = np.concatenate(s2_parts, axis=0)
    variances = (s2 - n * means**2) / (n - 1)
    W = variances.mean(axis=0)
    B_over_n = means.var(axis=0, ddof=1)                  # = B / n
    var_plus = (n - 1) / n * W + B_over_n
    return np.sqrt(var_plus / np.where(W > 0, W, np.inf))


def device_split_rhat(chain_pieces) -> np.ndarray:
    """Split-chain R-hat computed ON the accelerator (same math as
    :func:`split_rhat`, in the chain's own precision after global centering —
    the centering removes the catastrophic s2 - n*mu^2 cancellation, so f32
    moment accumulation is accurate to ~1e-5, far inside the diagnostic's
    resolution). Downloads only the (ndim,) result; companion of
    :func:`device_mean_power` for the post-production host-offload path."""
    import jax.numpy as jnp

    if isinstance(chain_pieces, (list, tuple)):
        dev = (
            jnp.concatenate([jnp.asarray(p) for p in chain_pieces], axis=0)
            if len(chain_pieces) > 1
            else jnp.asarray(chain_pieces[0])
        )
    else:
        dev = jnp.asarray(chain_pieces)
    return np.asarray(_device_jits()[1](dev))


def warm_fft_plans(n_t: int) -> None:
    """Precompute pocketfft plans for the integrated_time transform length.

    First-use FFT planning at a given length costs seconds on a small host;
    the plan is cached per process. Call this while the device is busy (e.g.
    right after dispatching the production scan) so ``integrated_time`` on the
    downloaded chain only pays the ~2 s compute. Pure scipy — safe to run
    while device programs execute.
    """
    from scipy import fft as sfft

    x = np.zeros((n_t, 1), np.float32)
    lags = {_acf_lag_cap(n_t), n_t}  # truncated length + full-length fallback
    for L in sorted(lags):
        nfft = sfft.next_fast_len(n_t + L - 1, real=True)
        f = sfft.rfft(x, n=nfft, axis=0)
        sfft.irfft(f, n=nfft, axis=0)
    # device_mean_power path: only the pow2 irfft runs on the host
    nfft = 2 * _next_pow_two(n_t)
    sfft.irfft(np.zeros((nfft // 2 + 1, 1), np.complex64), n=nfft, axis=0)


def integrated_time(
    chain: npt.NDArray,
    c: float = 5.0,
    tol: float = 50.0,
    quiet: bool = False,
    mean_power: tuple[npt.NDArray, int] | None = None,
) -> npt.NDArray:
    """Integrated autocorrelation time per parameter for a (n_steps, n_walkers, ndim) chain.

    Averages the walker autocorrelation functions, applies Sokal's automatic
    windowing with parameter ``c``, and raises AutocorrError when the chain is
    shorter than ``tol`` autocorrelation times (unless ``quiet``).

    ``mean_power``: optional precomputed ``(power, nfft)`` walker-averaged ACF
    power spectrum from :func:`device_mean_power` — the expensive forward
    transforms then stay on the accelerator and only the cheap inverse
    transform + windowing run here. The spectrum is full-length, so no lag cap
    or redo applies.
    """
    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t, n_w, n_d = chain.shape
    if mean_power is not None:
        power, nfft = mean_power
        tau_est, _ = integrated_time_from_power(
            power, nfft, n_t, c=c, tol=tol, out_dtype=chain.dtype
        )
    else:
        L = _acf_lag_cap(n_t)
        taus_all = _mean_acf_taus(chain.reshape(n_t, 1, n_w, n_d), max_lag=L)[:, 0, :]
        wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
        if L < n_t and any(w == 0 for w in wins):
            # window not found within the lag cap for some parameter (w == 0
            # can only mean all-True m) — redo exact full-length for identical
            # semantics on pathological chains
            taus_all = _mean_acf_taus(chain.reshape(n_t, 1, n_w, n_d))[:, 0, :]
            wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
        tau_est = np.array([taus_all[w, d] for d, w in enumerate(wins)])

    if np.any(tol * tau_est > n_t):
        msg = (
            f"The chain is shorter than {tol} times the integrated autocorrelation time "
            f"for {np.sum(tol * tau_est > n_t)} parameter(s). Use this estimate with caution! "
            f"N/{tol} = {n_t / tol:.0f}; tau: {tau_est}"
        )
        if not quiet:
            raise AutocorrError(msg)
    return tau_est


def _mean_acf_taus(
    chain: npt.NDArray, max_chunk_series: int = 4096, max_lag: int | None = None
) -> npt.NDArray:
    """Cumulative tau estimates 2*cumsum(mean_acf)-1 of shape (L, P, n_d),
    where L = min(max_lag, n_t) (lags beyond L are not computed; they are
    exact up to L — see _ACF_MAX_LAG).

    ``chain`` is (n_t, P, n_w, n_d): P independent chain batches (closure
    points), walker-averaged per (point, parameter) exactly as emcee does.

    Scaling each centered series by 1/sqrt(sum dx^2) makes its ACF zero-lag
    exactly 1, so mean_w(acf_w / acf0_w) == irfft(mean_w |rfft(dx_w/s_w)|^2):
    the walker average happens on the POWER SPECTRA and the inverse transform
    runs over only P*n_d series instead of P*n_w*n_d (~100x less inverse-FFT
    work than transforming every walker back). Forward transforms process
    whole points at a time (at most ~``max_chunk_series`` series per chunk) so
    the walker sum is a plain reshape-reduction with f64 accumulation —
    np.add.at scatter was ~8x slower — and the transient complex buffer stays
    bounded for production closure batches. Padding to
    next_fast_len(n_t + L - 1) keeps the linear autocorrelation exact at all
    computed lags < L (any pad >= n_t + L - 1 does); at L = n_t this is
    emcee's full ACF with ~25% fewer points than its 2*next_pow_two(n_t).
    """
    from scipy import fft as sfft

    import os

    n_t, P, n_w, n_d = chain.shape
    L = n_t if max_lag is None else min(int(max_lag), n_t)
    workers = os.cpu_count() or 1
    nfft = sfft.next_fast_len(n_t + L - 1, real=True)
    x = (chain - chain.mean(axis=0)).reshape(n_t, P * n_w * n_d)
    norm = np.sqrt(np.einsum("tj,tj->j", x, x))
    x *= 1.0 / np.where(norm == 0.0, 1.0, norm)

    group = n_w * n_d
    pts_chunk = max(1, max_chunk_series // group)
    power = np.empty((nfft // 2 + 1, P, n_d), np.float64)
    for p0 in range(0, P, pts_chunk):
        p1 = min(P, p0 + pts_chunk)
        f = sfft.rfft(x[:, p0 * group : p1 * group], n=nfft, axis=0, workers=workers)
        # |f|^2 without strided .real/.imag gathers: square the interleaved
        # re/im float view contiguously and fold the pair-sum into the f64
        # walker reduction (contiguous passes; chain precision preserved)
        sq = np.square(f.view(x.dtype))
        power[:, p0:p1] = sq.reshape(-1, p1 - p0, n_w, n_d, 2).sum(
            axis=(2, 4), dtype=np.float64
        )
    power /= n_w
    return _taus_from_power(power, nfft, L, chain.dtype, workers=workers)


def _taus_from_power(
    power: npt.NDArray, nfft: int, L: int, out_dtype, workers: int = 1
) -> npt.NDArray:
    """Cumulative tau estimates from a walker-averaged power spectrum.

    ``power``: (nfft//2+1, P, n_d). The inverse transform runs in the chain's
    own precision: float32 chains (device downloads) keep the cheap
    single-precision irfft; float64 chains preserve the accuracy the
    per-walker estimator delivers. Returns (L, P, n_d).
    """
    from scipy import fft as sfft

    _, P, n_d = power.shape
    mean_acf = sfft.irfft(
        power.reshape(-1, P * n_d).astype(out_dtype), n=nfft, axis=0, workers=workers
    )[:L]
    return 2.0 * np.cumsum(mean_acf, axis=0, dtype=np.float64).reshape(L, P, n_d) - 1.0


def integrated_time_from_power(
    power: npt.NDArray,
    nfft: int,
    n_t: int,
    c: float = 5.0,
    tol: float = 50.0,
    out_dtype=np.float32,
) -> tuple[npt.NDArray, npt.NDArray]:
    """Sokal-windowed tau from a full-length walker-averaged power spectrum
    (:func:`device_mean_power`). Returns (tau (n_d,), reliable (n_d,) bool —
    False where the chain is shorter than ``tol`` tau)."""
    taus_all = _taus_from_power(np.asarray(power)[:, None, :], nfft, n_t, out_dtype)[:, 0, :]
    n_d = taus_all.shape[1]
    wins = [_auto_window(taus_all[:, d], c) for d in range(n_d)]
    tau = np.array([taus_all[w, d] for d, w in enumerate(wins)])
    return tau, tol * tau <= n_t


def tau_vs_length_from_power(
    power: npt.NDArray,
    nfft: int,
    n_t: int,
    lengths,
    c: float = 5.0,
    out_dtype=np.float64,
) -> npt.NDArray:
    """Approximate tau-vs-chain-length convergence curve from ONE full-chain
    walker-averaged power spectrum (:func:`device_mean_power`).

    The exact curve re-estimates the ACF from every chain prefix — ~8 host
    forward-FFT passes over all walker series on a CPU-steal-prone 1-vCPU
    host (reference counterpart plot_mcmc.py:151-233). This variant reuses
    the full-chain ACF the runner already computed ON DEVICE (one cheap
    inverse transform here) and applies Sokal's window per length with the
    searchable lag range capped at that length. Semantics preserved: where
    the curve flattens and where it crosses the N/50 line; the FINAL point is
    exactly the full-chain estimate. Early points differ from the exact
    prefix estimator only by its extra estimator noise (the prefix ACF is a
    noisier estimate of the same function). Returns (len(lengths), n_d).
    """
    taus_all = _taus_from_power(
        np.asarray(power)[:, None, :], nfft, n_t, out_dtype
    )[:, 0, :]
    n_d = taus_all.shape[1]
    lengths = np.asarray(lengths, int)
    out = np.empty((len(lengths), n_d))
    for i, n in enumerate(lengths):
        L = min(int(n), n_t)
        for d in range(n_d):
            out[i, d] = taus_all[_auto_window(taus_all[:L, d], c), d]
    return out


def device_mean_power(chain_pieces) -> tuple[np.ndarray, int]:
    """Walker-averaged ACF power spectrum computed ON the accelerator.

    The forward transforms are the expensive part of ``integrated_time``
    (600 series x 50k+ points); here they run as one batched device FFT
    instead of host passes whose time depends on the host's free cores. Only
    the (nfft//2+1, n_d) spectrum is downloaded (~1.6 MB at production
    scale); pass the result to ``integrated_time(..., mean_power=...)``.

    ``chain_pieces``: one (n_t, n_w, n_d) array or a list of time-axis slabs
    (device handles and/or host arrays — e.g. a resumed prefix plus the live
    chunks) concatenated on device. Full-length transform (no lag cap):
    nfft = 2 * next_pow_two(n_t), exactly emcee's choice.
    """
    import jax.numpy as jnp

    if isinstance(chain_pieces, (list, tuple)):
        dev = (
            jnp.concatenate([jnp.asarray(p) for p in chain_pieces], axis=0)
            if len(chain_pieces) > 1
            else jnp.asarray(chain_pieces[0])
        )
    else:
        dev = jnp.asarray(chain_pieces)
    n_t = dev.shape[0]
    nfft = 2 * _next_pow_two(n_t)
    return np.asarray(_device_jits()[0](dev, nfft)), nfft


def device_closure_stats(chain_pieces) -> tuple[np.ndarray, int, np.ndarray]:
    """Per-point ACF power spectra + split-R-hat for a batched closure run,
    computed ON the accelerator in ONE program.

    ``chain_pieces``: (n_chunk, P, n_w, n_d) time-axis slabs. The program
    scans over the P points (FFT working buffers are reused per iteration, so
    HBM stays bounded at one point's transform); only the (P, nfft//2+1, n_d)
    spectra and (P, n_d) R-hats download. A single compiled program — NOT a
    per-point host loop, which would compile one program per literal slice
    index. Returns
    (power (P, nfft//2+1, n_d), nfft, rhat (P, n_d)).
    """
    import jax.numpy as jnp

    full = (
        jnp.concatenate([jnp.asarray(p) for p in chain_pieces], axis=0)
        if len(chain_pieces) > 1
        else jnp.asarray(chain_pieces[0])
    )  # (n_t, P, n_w, n_d)
    n_t = full.shape[0]
    nfft = 2 * _next_pow_two(n_t)
    power, rhat = _device_jits()[2](full, nfft)
    return np.asarray(power), nfft, np.asarray(rhat)


_DEVICE_JITS = None


def _device_jits():
    """Lazily-built jitted device programs: (power, rhat, closure_scan)."""
    global _DEVICE_JITS
    if _DEVICE_JITS is None:
        import functools

        import jax
        import jax.numpy as jnp

        def power_math(chain, nfft: int):
            n_t, n_w, n_d = chain.shape
            x = chain.reshape(n_t, n_w * n_d)
            x = x - jnp.mean(x, axis=0, keepdims=True)
            norm2 = jnp.einsum("tj,tj->j", x, x)
            x = x / jnp.sqrt(jnp.where(norm2 == 0.0, 1.0, norm2))
            f = jnp.fft.rfft(x, n=nfft, axis=0)
            pw = jnp.real(f) ** 2 + jnp.imag(f) ** 2
            # Walker mean in the chain's own precision (f32 over <=1k walkers:
            # ~1e-6 relative — far below the tau estimator's statistical error)
            return jnp.mean(pw.reshape(-1, n_w, n_d), axis=1)

        def rhat_math(chain):
            n_t = chain.shape[0] - (chain.shape[0] % 2)
            half = n_t // 2
            c = chain[:n_t] - jnp.mean(chain[:n_t], axis=(0, 1), keepdims=True)
            parts = [c[:half], c[half:]]
            means = jnp.concatenate([jnp.mean(p, axis=0) for p in parts], axis=0)
            s2 = jnp.concatenate(
                [jnp.einsum("twd,twd->wd", p, p) for p in parts], axis=0
            )
            variances = (s2 - half * means**2) / (half - 1)
            W = jnp.mean(variances, axis=0)
            B_over_n = jnp.var(means, axis=0, ddof=1)
            var_plus = (half - 1) / half * W + B_over_n
            return jnp.sqrt(var_plus / jnp.where(W > 0, W, jnp.inf))

        @functools.partial(jax.jit, static_argnames=("nfft",))
        def power_jit(chain, nfft: int):
            return power_math(chain, nfft)

        rhat_jit = jax.jit(rhat_math)

        @functools.partial(jax.jit, static_argnames=("nfft",))
        def closure_jit(full, nfft: int):
            def body(carry, p):
                ch = jax.lax.dynamic_slice_in_dim(full, p, 1, axis=1)[:, 0]
                return carry, (power_math(ch, nfft), rhat_math(ch))

            _, out = jax.lax.scan(body, 0, jnp.arange(full.shape[1]))
            return out

        _DEVICE_JITS = (power_jit, rhat_jit, closure_jit)
    return _DEVICE_JITS


def integrated_time_batched(
    chain: npt.NDArray, c: float = 5.0, tol: float = 50.0
) -> tuple[npt.NDArray, npt.NDArray]:
    """Integrated autocorrelation time for a batch of independent chains.

    ``chain``: (n_t, P, n_w, n_d) — P closure points' chains diagnosed in ONE
    batched FFT pass (the reference loops emcee's estimator point by point,
    steer_analysis.py:174-181 -> mcmc.py:110-119). Returns (tau (P, n_d),
    reliable (P, n_d) bool mask — False where the chain is shorter than
    ``tol`` tau, matching the AutocorrError condition of ``integrated_time``).
    """
    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    n_t, P, n_w, n_d = chain.shape
    L = _acf_lag_cap(n_t)
    taus_all = _mean_acf_taus(chain, max_lag=L)  # (L, P, n_d)
    flat = taus_all.reshape(L, P * n_d)
    m = np.arange(L)[:, None] < c * flat
    win = np.where(m.any(axis=0), np.argmin(m, axis=0), L - 1)
    if L < n_t and np.any(win == 0):
        # some series' window lies beyond the lag cap — exact full-length redo
        flat = _mean_acf_taus(chain).reshape(n_t, P * n_d)
        m = np.arange(n_t)[:, None] < c * flat
        win = np.where(m.any(axis=0), np.argmin(m, axis=0), n_t - 1)
    tau = flat[win, np.arange(flat.shape[1])].reshape(P, n_d)
    reliable = tol * tau <= n_t
    return tau, reliable


def integrated_time_per_walker(chain: npt.NDArray, c: float = 5.0, tol: float = 50.0) -> tuple[npt.NDArray, npt.NDArray]:
    """Per-walker integrated autocorrelation time (reference plot_mcmc.py:179-204,
    which loops emcee.autocorr.integrated_time over single-walker chains).

    One batched FFT over all (walker, parameter) series, then Sokal windowing
    vectorized over every series independently (no cross-walker averaging).

    Returns (tau, reliable): tau shape (n_walkers, n_dim); ``reliable`` is a
    same-shape boolean mask, False where the chain is shorter than ``tol`` tau
    (the reference logs those walkers and leaves their entries at zero — keep
    the values and let the caller decide).
    """
    from scipy import fft as sfft

    import os

    chain = np.asarray(chain)
    if not np.issubdtype(chain.dtype, np.floating):
        chain = chain.astype(np.float64)
    if chain.ndim == 2:
        chain = chain[:, :, None]
    n_t, n_w, n_d = chain.shape
    x = (chain - chain.mean(axis=0)).reshape(n_t, n_w * n_d)
    workers = os.cpu_count() or 1

    def _taus_and_windows(L: int):
        nfft = sfft.next_fast_len(n_t + L - 1, real=True)
        f = sfft.rfft(x, n=nfft, axis=0, workers=workers)
        np.multiply(f, np.conjugate(f), out=f)
        acf = sfft.irfft(f, n=nfft, axis=0, workers=workers)[:L]
        acf0 = acf[0]
        acf = acf / np.where(acf0 == 0.0, 1.0, acf0)
        taus_all = 2.0 * np.cumsum(acf.astype(np.float64), axis=0) - 1.0  # (L, s)
        # emcee auto_window semantics, vectorized per series
        m = np.arange(L)[:, None] < c * taus_all
        win = np.where(m.any(axis=0), np.argmin(m, axis=0), L - 1)
        return taus_all, win

    L = _acf_lag_cap(n_t)
    taus_all, win = _taus_and_windows(L)
    if L < n_t and np.any(win == 0):
        # some walker's window lies beyond the lag cap — exact full-length redo
        taus_all, win = _taus_and_windows(n_t)
    tau = taus_all[win, np.arange(taus_all.shape[1])].reshape(n_w, n_d)
    reliable = tol * tau <= n_t
    return tau, reliable
