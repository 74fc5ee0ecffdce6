"""Standard scaling + SVD principal-component analysis as a JAX pytree.

Replaces the reference's sklearn StandardScaler + PCA(svd_solver='full',
whiten=False) (emulation.py:109-123) with a single on-device SVD. Conventions
match sklearn so fitted states are numerically interchangeable:

  - features are centered and scaled to unit variance (ddof=0),
  - components are the right singular vectors with sklearn's deterministic
    sign flip (the column of U with the largest |entry| is made positive),
  - explained_variance_ = s^2 / (n_samples - 1).

Transform: Z = ((Y - mean)/scale) @ components.T ; inverse composes the
reverse. Everything is a plain pytree so it vmaps/jits/checkpoints freely.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from bayesian_inference_tpu.utils import struct


@struct.dataclass
class PCAState:
    """Fitted scaler + PCA. All leaves are arrays; safe to jit/vmap/serialize."""

    mean: jax.Array            # (n_features,)  per-feature mean
    scale: jax.Array           # (n_features,)  per-feature std (ddof=0)
    components: jax.Array      # (n_components, n_features) rows = principal axes
    explained_variance: jax.Array        # (n_components,)
    explained_variance_ratio: jax.Array  # (n_components,)
    singular_values: jax.Array           # (n_components,)

    @property
    def n_components(self) -> int:
        return self.components.shape[0]

    def scale_features(self, Y: jax.Array) -> jax.Array:
        return (Y - self.mean) / self.scale

    def unscale_features(self, Y_scaled: jax.Array) -> jax.Array:
        return Y_scaled * self.scale + self.mean

    def transform(self, Y: jax.Array, n_pc: int | None = None) -> jax.Array:
        comps = self.components if n_pc is None else self.components[:n_pc]
        return self.scale_features(Y) @ comps.T

    def inverse_transform(self, Z: jax.Array) -> jax.Array:
        n_pc = Z.shape[-1]
        return self.unscale_features(Z @ self.components[:n_pc])

    def reconstruction(self, Y: jax.Array, n_pc: int) -> jax.Array:
        """Round-trip Y through the first n_pc components (diagnostics)."""
        return self.inverse_transform(self.transform(Y, n_pc=n_pc))

    def to_host_dict(self) -> dict[str, Any]:
        import numpy as np

        return {k: np.asarray(v) for k, v in vars(self).items()}

    @classmethod
    def from_host_dict(cls, d: dict[str, Any]) -> "PCAState":
        return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _svd_sign_flip(U, Vt):
    """sklearn's svd_flip(u_based_decision=False), the PCA full-solver
    convention: per-row of Vt, flip so the largest-|.| entry is positive;
    apply the same flip to the columns of U. (host-side numpy)"""
    import numpy as np

    idx = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(Vt[np.arange(Vt.shape[0]), idx])
    signs[signs == 0] = 1.0
    return U * signs, Vt * signs[:, None]


def fit_pca(Y, max_n_components: int | None = None) -> tuple[PCAState, "jax.Array"]:
    """Fit scaler + full-SVD PCA; returns (state, Y_pca) with Y_pca = all-PC scores.

    ``max_n_components`` caps how many PCs are kept (the reference's
    max_n_components_to_calculate, emulation.py:112-115).

    Runs ENTIRELY on the host (LAPACK float64 SVD of a ~(200, 215) matrix) and
    returns HOST numpy leaves in the canonical jax dtype: PCA is one-time setup
    math, and every eager device op compiles a program of its own. Callers
    upload exactly the pieces the
    device needs (e.g. the truncated PC scores for the GP fit); PCAState's
    methods are dtype-polymorphic, so they work on numpy leaves directly and
    still trace cleanly if a state is passed into a jit program.
    """
    import numpy as np

    in_dtype = np.asarray(Y).dtype if hasattr(Y, "dtype") else np.float64
    dtype = jax.dtypes.canonicalize_dtype(in_dtype)
    Yh = np.asarray(Y, np.float64)
    n_samples = Yh.shape[0]
    mean = Yh.mean(axis=0)
    scale = Yh.std(axis=0)
    scale[scale == 0.0] = 1.0
    Y_scaled = (Yh - mean) / scale

    U, s, Vt = np.linalg.svd(Y_scaled, full_matrices=False)
    U, Vt = _svd_sign_flip(U, Vt)
    U, Vt, s = np.asarray(U), np.asarray(Vt), np.asarray(s)

    explained_variance = (s**2) / (n_samples - 1)
    ratio = explained_variance / explained_variance.sum()

    k = min(max_n_components, s.shape[0]) if max_n_components is not None else s.shape[0]
    state = PCAState(
        mean=np.asarray(mean, dtype),
        scale=np.asarray(scale, dtype),
        components=np.asarray(Vt[:k], dtype),
        explained_variance=np.asarray(explained_variance[:k], dtype),
        explained_variance_ratio=np.asarray(ratio[:k], dtype),
        singular_values=np.asarray(s[:k], dtype),
    )
    Y_pca = np.asarray(U[:, :k] * s[:k], dtype)
    return state, Y_pca


def truncation_covariance(state: PCAState, n_pc: int):
    """Predictive covariance of the discarded PCs, in *scaled* feature space.

    Sigma_unexplained = S_{>n_pc} D^2_{>n_pc} S_{>n_pc}^T (eqs 21-22 of
    arXiv:2102.11337; reference emulation.py:227-251). Computed from the stored
    components beyond n_pc — requires the state to have been fit with enough
    components retained. Polymorphic: numpy leaves give host math (the MCMC
    setup path), jax leaves give device math.
    """
    S_rest = state.components[n_pc:].T          # (n_features, n_rest)
    D2 = state.explained_variance[n_pc:]
    return (S_rest * D2) @ S_rest.T
