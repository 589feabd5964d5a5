"""GSPMD sharding path: the single-device step under jit + mesh shardings.

The scaling-book recipe verbatim: pick a mesh, annotate shardings on the
inputs, and let XLA partition the computation — the shifted-slice reads in
the curl updates become collective-permute halo exchanges
automatically.  Zero extra numerics code; bit-identical to the explicit
shard_map path.  Use this for quick scaling; use
:mod:`fdtd_tpu.parallel.sharded_step` when hand-tuned comm scheduling wins.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh

from ..params import Params
from ..state import Materials
from ..step import make_step
from .mesh import field_sharding


def make_gspmd_chunk_runner(p: Params, mesh: Mesh, materials: Materials | None = None):
    """Jitted ``run(state, xs) -> state`` with fields sharded over ``mesh``.

    ``state`` must already be placed with :func:`pad_state_for_mesh` (the
    update slices only touch the physical region, so the divisibility
    padding is inert).
    """
    step = make_step(p, materials)
    fsh = field_sharding(mesh)

    @jax.jit
    def run(s, xs):
        s = jax.tree.map(lambda a: jax.lax.with_sharding_constraint(a, fsh), s)

        def body(s, x):
            return step(s, x), None

        s, _ = jax.lax.scan(body, s, xs)
        return s

    return run
