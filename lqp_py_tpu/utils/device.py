"""The accelerator a measurement runs on.

Every script that reports a device number (``chip_smoke.py``, ``bench.py``,
``tools/bench_factorization.py``) starts with ``require_gpu``: a run that
finds no GPU stops instead of timing the CPU under a device's name.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """The first JAX device, or ``SystemExit`` when it is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found {dev.platform} "
            f"({dev.device_kind}) — not measuring on it")
    return dev


def card_info() -> str:
    """``name, power limit`` of each card as nvidia-smi reports them, read
    in a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def describe(dev) -> str:
    """One line naming the device for a measurement's output."""
    return (f"device: platform={dev.platform} kind={dev.device_kind} "
            f"count={len(jax.devices())} | nvidia-smi: {card_info()}")
