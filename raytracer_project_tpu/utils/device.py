"""Accelerator identity for the entry points that measure on a card
(bench.py, chip_smoke.py): they refuse to run without a GPU instead of
falling back to the CPU, and name the device beside every number."""

from __future__ import annotations

import subprocess


def require_gpu() -> list:
    """jax.devices(), or SystemExit (nonzero, nothing on stdout) when JAX
    found no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found only {devs[0].platform} devices {devs}")
    return devs


def device_summary(devs) -> dict:
    """The device as JAX reports it: platform, device_kind, count."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_lines() -> list[str]:
    """One `name, power.limit` line per card, as nvidia-smi reports them. A
    card may be capped below its maximum power and then runs slower under
    load, so every measurement is printed beside these lines."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
