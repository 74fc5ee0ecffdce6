"""The device a measurement ran on, as JAX and nvidia-smi report it.

Every timing this repository prints names its card: JAX's platform, device
kind and device count, and the card's name and power limit (a card set below
its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """Platform, kind and count of JAX's devices; exits unless they are GPUs."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
    if info["platform"] != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found {info}")
    return info
