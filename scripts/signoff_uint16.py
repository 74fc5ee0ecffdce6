"""uint16 chain-transfer parity sign-off (docs/PARITY.md).

The quantized transfer perturbs ONLY the downloaded chain values (sampling is
bit-identical — tests/test_mcmc.py::test_production_uint16_chain_transfer_parity),
so the sign-off is deterministic: take a real production-scale chain, apply
the exact quantize/dequantize round-trip the transfer performs, and compare
posterior quantiles and integrated autocorrelation times. The deltas must be
negligible against the chain's own Monte-Carlo error.

Usage: python scripts/signoff_uint16.py [path/to/mcmc.h5]
(defaults to the production bench chain; runs entirely on host numpy).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).parent.parent
sys.path.insert(0, str(REPO / "src"))

import numpy as np

# Force host-only work: stats.integrated_time with numpy input stays on host.
from bayesian_inference_tpu.mcmc import stats

PROD_MIN = np.array([0.1, 1, 0.006737946999085467, 0.006737946999085467, 0, 0.049787068367863944])
PROD_MAX = np.array([0.5, 10, 10, 10, 1.5, 100])

path = Path(sys.argv[1]) if len(sys.argv) > 1 else (
    REPO / "output/bench_production/output/bench_exponential/mcmc.h5"
)
from bayesian_inference_tpu.io.hdf5 import read_datasets

datasets = read_datasets(str(path.parent), path.name, ["chain", "log_prob"])
chain = datasets["chain"]  # (n_steps, W, d)
log_prob = datasets.get("log_prob")
n, W, d = chain.shape
print(f"# chain {chain.shape} from {path}", file=sys.stderr)

scale = 65535.0 / (PROD_MAX - PROD_MIN)
q = np.clip(np.rint((chain - PROD_MIN) * scale), 0, 65535).astype(np.uint16)
deq = PROD_MIN + q.astype(np.float64) / scale

flat = chain.reshape(-1, d)
flat_q = deq.reshape(-1, d)
prior_w = PROD_MAX - PROD_MIN

rows = []
for i in range(d):
    tau = float(stats.integrated_time(chain[:, :, i], quiet=True))
    tau_q = float(stats.integrated_time(deq[:, :, i], quiet=True))
    n_eff = n * W / max(tau, 1.0)
    qs = np.percentile(flat[:, i], [16, 50, 84])
    qs_q = np.percentile(flat_q[:, i], [16, 50, 84])
    # MC standard error of a quantile ~ sqrt(p(1-p)/n_eff)/density; use the
    # conservative iqr-based proxy: se ≈ (q84-q16)/2 / sqrt(n_eff).
    se = (qs[2] - qs[0]) / 2 / np.sqrt(n_eff)
    rows.append({
        "dim": i,
        "tau": round(tau, 2),
        "dtau_rel": round(abs(tau_q - tau) / tau, 6),
        "dq_over_prior_width": [round(abs(a - b) / w, 9) for a, b, w in
                                zip(qs_q, qs, [prior_w[i]] * 3)],
        "dq_over_mc_se": [round(abs(a - b) / se, 5) for a, b in zip(qs_q, qs)],
        "max_coord_err_over_prior_width": round(
            float(np.abs(deq[:, :, i] - chain[:, :, i]).max()) / prior_w[i], 9),
    })

out = {
    "chain": str(path),
    "shape": [int(n), int(W), int(d)],
    "bound_per_coord": "prior_width/131070 = 7.63e-6",
    "dims": rows,
    "max_dq_over_mc_se": max(max(r["dq_over_mc_se"]) for r in rows),
    "max_dtau_rel": max(r["dtau_rel"] for r in rows),
}

if log_prob is not None:
    # log-prob transfer sign-off: apply the per-chunk min/span uint16
    # round-trip (mcmc/runner.py::_quantize_minmax_u16) over the production
    # ramp's chunk layout and report the worst absolute/relative archive
    # error. log_prob is a plot-only diagnostic (traces + histogram); the
    # sampler state and chain are untouched by construction.
    import types

    from bayesian_inference_tpu.mcmc.runner import _production_sizes

    sizes = _production_sizes(
        types.SimpleNamespace(n_sampling_steps=n, n_logging_steps=1000), None
    ) or [n]
    max_abs, max_span = 0.0, 0.0
    pos = 0
    for s in sizes:
        lp = log_prob[pos : pos + s]
        fin = np.isfinite(lp)
        lo, hi = lp[fin].min(), lp[fin].max()
        span = max(hi - lo, np.finfo(np.float64).tiny)
        q = np.clip(np.rint((lp - lo) * (65534.0 / span)), 0, 65534)
        deq = lo + q * (span / 65534.0)
        max_abs = max(max_abs, float(np.abs(deq[fin] - lp[fin]).max()))
        max_span = max(max_span, float(span))
        pos += s
    lp_fin = log_prob[np.isfinite(log_prob)]
    out["log_prob"] = {
        "chunk_layout": sizes,
        "max_abs_err_nats": round(max_abs, 8),
        "max_chunk_span_nats": round(max_span, 3),
        "posterior_logp_std_nats": round(float(lp_fin.std()), 3),
        "err_over_logp_std": round(max_abs / float(lp_fin.std()), 8),
    }
print(json.dumps(out, indent=1))
