"""Device mesh construction and field shardings.

The reference parallelizes with a 1-D MPI Z-slab decomposition and ghost
planes (description.pdf section 2.2).  Here the spatial grid shards over a
1-D, 2-D or 3-D ``jax.sharding.Mesh`` with axes ('z', 'y', 'x') mapped onto
the (k, j, i) array axes; halo traffic rides XLA collective-permutes (NCCL
on GPUs).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import Params
from ..state import FieldState

AXES = ("z", "y", "x")


def factor3(n: int) -> tuple[int, int, int]:
    """Split n into 3 factors, as cubic as possible, z-major."""
    best = (n, 1, 1)
    best_cost = float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        m = n // a
        for b in range(1, m + 1):
            if m % b:
                continue
            c = m // b
            cost = max(a, b, c) / min(a, b, c)
            if cost < best_cost:
                best_cost = cost
                best = tuple(sorted((a, b, c), reverse=True))
    return best


def make_mesh(
    n_devices: int | None = None,
    shape: tuple[int, int, int] | None = None,
    devices=None,
) -> Mesh:
    """A ('z', 'y', 'x') mesh over ``n_devices`` of ``devices`` (default:
    the default backend's devices).  Too few devices is an error: a mesh
    never moves to another platform's devices.  For a virtual CPU mesh, set
    XLA_FLAGS=--xla_force_host_platform_device_count=N and
    JAX_PLATFORMS=cpu before the first JAX call (see tests/conftest.py)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if shape is None:
        shape = factor3(n_devices)
    assert math.prod(shape) == n_devices
    if len(devices) < n_devices:
        raise ValueError(
            f"a {n_devices}-device mesh needs {n_devices} "
            f"{devices[0].platform} devices; {len(devices)} available"
        )
    dev_array = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(dev_array, AXES)


def field_spec() -> P:
    return P(*AXES)


def field_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, field_spec())


def padded_divisible_shape(p: Params, mesh: Mesh) -> tuple[int, int, int]:
    """Global shape, padded up so each (k, j, i) axis divides the mesh axis."""
    K1, J1, I1 = p.padded_shape
    nz, ny, nx = (mesh.shape[a] for a in AXES)

    up = lambda v, m: ((v + m - 1) // m) * m
    return (up(K1, nz), up(J1, ny), up(I1, nx))


def pad_state_for_mesh(p: Params, s: FieldState, mesh: Mesh) -> FieldState:
    """Zero-pad fields to the mesh-divisible shape and place on the mesh."""
    import jax.numpy as jnp

    Kp, Jp, Ip = padded_divisible_shape(p, mesh)
    K1, J1, I1 = p.padded_shape
    sh = field_sharding(mesh)

    def pad(a):
        a = jnp.pad(a, ((0, Kp - K1), (0, Jp - J1), (0, Ip - I1)))
        return jax.device_put(a, sh)

    return jax.tree.map(pad, s)


def unpad_state(p: Params, s: FieldState) -> FieldState:
    K1, J1, I1 = p.padded_shape
    return jax.tree.map(lambda a: a[:K1, :J1, :I1], s)
