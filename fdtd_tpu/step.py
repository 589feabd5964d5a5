"""The jitted leapfrog step and scan driver.

One step replicates the reference loop body order exactly (reference:
main.c:765-779): [source] -> update_H -> [source] -> update_E.  The source is
applied twice per step in computation mode — an observable quirk of the
reference that is part of field-evolution parity (SURVEY section 2.4 item 4).

The whole step is traced once under ``jax.jit``; multi-step runs use
``lax.scan`` over the per-step time values (precomputed host-side with the
reference's exact fp64 accumulation, see :func:`fdtd_tpu.params.time_values`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from .params import Mode, Params
from .source import SourcePlan, apply_source, make_source_plan
from .state import FieldState, Materials, UpdateCoefs, update_coefs
from .ops import curl
from . import diagnostics


BACKENDS = ("auto", "xla")
# Names of removed kernel tiers; scripts that still pass them get a clear
# refusal instead of "unknown backend".
REMOVED_BACKENDS = ("pallas", "pallas_fused", "pallas_temporal", "pallas_stream")


def check_backend(backend: str) -> None:
    """Refuse every backend name but the one jnp path ("auto" == "xla")."""
    if backend in BACKENDS:
        return
    if backend in REMOVED_BACKENDS:
        raise ValueError(
            f"backend {backend!r} named a removed kernel tier, hand-written "
            "for the accelerator this package was first built for (README: "
            "'Where it comes from'); every run takes the jnp step (use "
            "'auto' or 'xla')"
        )
    raise ValueError(f"unknown backend {backend!r} (use 'auto' or 'xla')")


def make_step(
    p: Params,
    materials: Materials | None = None,
    coefs: UpdateCoefs | None = None,
) -> Callable[[FieldState, jax.Array], FieldState]:
    """Build the single-step function ``step(state, t) -> state``.

    The curl updates are the pure-jnp slice ops of :mod:`fdtd_tpu.ops.curl`,
    which XLA fuses.
    """
    if coefs is None:
        coefs = update_coefs(p, materials)
    plan: SourcePlan | None = (
        make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    )
    del materials  # folded into coefs

    def step(s: FieldState, x) -> FieldState:
        """One leapfrog step; ``x`` = (t, drive_amp) per :func:`scan_inputs`."""
        _t, amp = x
        if plan is not None:
            s = apply_source(plan, s, amp)
        s = curl.update_h(p, s, coefs)
        if plan is not None:
            s = apply_source(plan, s, amp)
        s = curl.update_e(p, s, coefs)
        return s

    return step


def scan_inputs(p: Params, times):
    """Per-step scan inputs: (t, drive_amp) arrays for ``lax.scan``.

    Drive amplitudes are precomputed host-side in libm fp64 (see
    :func:`fdtd_tpu.source.drive_values`).
    """
    import numpy as np

    times = np.asarray(times, dtype=np.float64)
    if p.mode == Mode.COMPUTATION:
        from .source import drive_values, make_source_plan as _msp

        amps = drive_values(_msp(p), times)
    else:
        amps = np.zeros_like(times)
    return times, amps


@dataclasses.dataclass(frozen=True)
class RunOutputs:
    state: FieldState
    power_j: jax.Array | None  # accumulated sigma*|E|^2*dt per cell (J/m^3)


def make_chunk_runner(
    p: Params,
    materials: Materials | None = None,
    accumulate_power: bool = False,
):
    """Jitted ``run(state, times, power_acc) -> (state, power_acc)``.

    Scans the step over a chunk of time values (typically ``sampling_rate``
    steps between snapshots).  Optionally accumulates dissipated energy
    density for SAR/heating maps (lossy materials only).  The input state
    is not donated: callers keep ordinary value semantics.
    """
    coefs = update_coefs(p, materials)
    step = make_step(p, materials, coefs=coefs)
    # vacuum has no conductivity: deposition is identically zero.  Host
    # numpy, folded into the jitted scan as a constant.
    import numpy as _np

    sigma = (
        _np.asarray(coefs.sigma_cells) if coefs.sigma_cells is not None else 0.0
    )
    dt_step = p.time_step

    @jax.jit
    def run(s, xs, power_acc=None):
        def body(carry, x):
            s, acc = carry
            s = step(s, x)
            if accumulate_power:
                # the accumulator stays fp32 whatever the field dtype
                inc = diagnostics.power_deposition(p, s, sigma)
                acc = acc + (inc * dt_step).astype(acc.dtype)
            return (s, acc), None

        (s, acc), _ = jax.lax.scan(body, (s, power_acc), xs)
        return s, acc

    return run


def zero_power_acc(p: Params):
    return jnp.zeros((p.maxk, p.maxj, p.maxi), dtype=jnp.float32)
