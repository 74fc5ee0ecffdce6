"""Device-mesh sharding for multi-chip scaling.

The reference's only parallelism is a multiprocessing pool over MCMC walkers
(mcmc.py:72-91). The JAX equivalents (SURVEY.md section 2 parallelism
checklist):

  - MCMC walkers shard along a 1-D "data" mesh axis: the ensemble state is
    small and replicated; the expensive batched likelihood is partitioned over
    walkers via sharding constraints, and XLA inserts the (tiny) all-gather of
    per-walker log-probabilities between devices.
  - GP fit instances (PCs x restarts) shard the same way: embarrassingly
    parallel hyperparameter optimization across chips in one pjit launch.

Single-chip runs pass mesh=None everywhere and pay zero overhead.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def get_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_leading_axis(x: jax.Array, mesh: Mesh | None, axis_name: str = "data") -> jax.Array:
    """Constrain the leading axis of ``x`` to be sharded over the mesh."""
    if mesh is None:
        return x
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def replicate(x, mesh: Mesh | None):
    """Constrain a pytree to be fully replicated over the mesh."""
    if mesh is None:
        return x
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.lax.with_sharding_constraint(a, sharding), x)


def make_sharded_log_prob(
    log_prob_fn: Callable[[jax.Array], jax.Array],
    mesh: Mesh | None,
    axis_name: str = "data",
) -> Callable[[jax.Array], jax.Array]:
    """Wrap a batched log-prob so the walker batch is partitioned over the mesh.

    Inside jit, XLA/GSPMD partitions every per-walker intermediate (GP kernel
    vectors, block Cholesky factors) across devices and all-gathers only the
    (W,) result.
    """
    if mesh is None:
        return log_prob_fn

    def sharded(theta: jax.Array) -> jax.Array:
        theta = shard_leading_axis(theta, mesh, axis_name)
        out = log_prob_fn(theta)
        return jax.lax.with_sharding_constraint(out, NamedSharding(mesh, P()))

    return sharded
