"""Test configuration.

Tests run on a virtual 8-device CPU mesh (multi-device sharding paths are
validated without accelerators) with x64 enabled so parity checks against
scipy/sklearn references are meaningful. GPU execution is exercised by
chip_smoke.py and bench.py instead.
"""

import os

# Force CPU even where JAX was imported before this file runs (env vars are
# then too late; jax.config.update applies until a backend initializes).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache (utils/compile_cache.py): the heavy
# integration tests compile multi-second scan programs; caching them makes
# repeat suite runs several minutes faster. Keyed on HLO, so source edits that
# change the program invalidate entries naturally.
from bayesian_inference_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()
assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"

import pytest

from config_factory import _DATA_DIR, make_analysis_yaml  # noqa: E402,F401  (re-export)


@pytest.fixture(scope="session")
def test_data_dir() -> Path:
    return _DATA_DIR
