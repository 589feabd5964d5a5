"""What a measurement runs on: the GPU gate and the card's identity.

Timing and smoke runs refuse to fall back to the CPU: a number taken there
says nothing about the card.  The card's name and power limit come from
``nvidia-smi`` in a child process, so the reading never touches JAX.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


class NoGpuError(RuntimeError):
    """JAX's default backend is not a GPU, or has too few of them."""


def require_gpus(count: int = 1):
    """The default backend's devices, which must be ``count`` or more GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoGpuError(
            f"no GPU found: JAX's default backend is {devs[0].platform!r} "
            f"({len(devs)} device(s)); this run measures the card and has "
            "no CPU fallback"
        )
    if len(devs) < count:
        raise NoGpuError(f"needs {count} GPUs; JAX found {len(devs)}")
    return devs


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_identity() -> str:
    """The card's name and power limit, one line per GPU, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip()
