"""Point probes + the unified monitored chunk runner.

Probes record per-step time series of the six cell-centered field
components at a handful of chosen cells — the light-weight monitor the
reference workflow can only emulate by dumping full Silo snapshots
every step (main.c:550-598) and post-extracting one cell.  A probe row
is 6 floats, so per-step capture costs nothing next to the update
sweep, and the series feeds resonance/spectrum analysis
(:mod:`fdtd_tpu.utils.spectrum`) without any volumetric storage.

``make_monitored_chunk_runner`` is the single scan that composes every
per-step diagnostic: SAR accumulation, DFT phasor sums
(:mod:`fdtd_tpu.dft`), and probe capture — one pass over the state per
step regardless of how many monitors are on.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .params import Params

COMPONENTS = ("ex", "ey", "ez", "hx", "hy", "hz")


@dataclasses.dataclass(frozen=True)
class ProbeSet:
    """Cell-centered probe locations as (k, j, i) cell indices."""

    cells: tuple

    def __post_init__(self):
        cells = tuple(tuple(int(c) for c in cell) for cell in self.cells)
        if not cells:
            raise ValueError("ProbeSet needs at least one cell")
        if any(len(c) != 3 for c in cells):
            raise ValueError("probe cells are (k, j, i) index triples")
        object.__setattr__(self, "cells", cells)

    def validate(self, p: Params) -> None:
        for k, j, i in self.cells:
            if not (0 <= k < p.maxk and 0 <= j < p.maxj and 0 <= i < p.maxi):
                raise ValueError(
                    f"probe cell (k={k}, j={j}, i={i}) is outside the "
                    f"{p.maxk}x{p.maxj}x{p.maxi} cell grid"
                )


@dataclasses.dataclass
class ProbeResult:
    cells: tuple  # ((k, j, i), ...)
    times: np.ndarray  # (n,) fp64 step times
    values: np.ndarray  # (n, n_probes, 6) fp32, component order COMPONENTS

    def series(self, probe: int, component: str) -> np.ndarray:
        """One probe's time series for a named component."""
        return self.values[:, probe, COMPONENTS.index(component)]


def probe_row(p: Params, full, cells):
    """(n_probes, 6) cell-centered field values for one step."""
    from . import diagnostics

    rows = []
    for k, j, i in cells:
        kk, jj, ii = slice(k, k + 1), slice(j, j + 1), slice(i, i + 1)
        es = diagnostics._e_cell_means(p, full, kk, jj, ii)
        hs = diagnostics._h_cell_means(p, full, kk, jj, ii)
        rows.append(
            jnp.stack([m[0, 0, 0].astype(jnp.float32) for m in (*es, *hs)])
        )
    return jnp.stack(rows)


def split_monitor_inputs(x, dft):
    """((t, amp), weights) from a scan input row — weights are the
    (cw, sw) DFT quadrature rows when a DFT is on, else None."""
    if dft is not None:
        t, amp, cw, sw = x
        return (t, amp), (cw, sw)
    return x, None


def apply_monitors(p: Params, full, weights, dft, cells, dacc):
    """One step of every enabled per-step monitor on a canonical-layout
    state: the DFT running sums and/or a probe row.  THE single
    definition of the monitor sampling — every monitored scan (closed
    cavity, PML, sharded, dispersive) calls this, so the paths cannot
    silently desynchronize."""
    from . import diagnostics
    from .dft import accumulate

    if dft is not None:
        cw, sw = weights
        cells_f = diagnostics._e_cell_means(p, full)
        if dft.fields == "eh":
            cells_f = (*cells_f, *diagnostics._h_cell_means(p, full))
        dacc = accumulate(p, cells_f, cw, sw, dacc)
    ys = probe_row(p, full, cells) if cells is not None else None
    return dacc, ys


def make_monitored_chunk_runner(
    p: Params,
    materials,
    dft=None,
    probes: ProbeSet | None = None,
    accumulate_power: bool = False,
):
    """``run(state, xs, power_acc, dft_acc) -> (state, power_acc,
    dft_acc, probe_ys)`` — one scan carrying every enabled per-step
    monitor.  ``xs`` is (ts, amps) plus (cw, sw) weight rows when a DFT
    is on (see :func:`fdtd_tpu.dft.dft_weights`); ``probe_ys`` is
    (n_steps, n_probes, 6) or None.  Not donating: monitor runs are
    diagnostics and keep value semantics."""
    from . import diagnostics
    from .state import update_coefs
    from .step import make_step

    if probes is not None:
        probes.validate(p)
    coefs = update_coefs(p, materials)
    step = make_step(p, materials, coefs=coefs)
    sigma = (
        np.asarray(coefs.sigma_cells)
        if coefs.sigma_cells is not None
        else 0.0
    )
    dt_step = p.time_step
    cells = probes.cells if probes is not None else None

    @jax.jit
    def run(s, xs, power_acc, dft_acc):
        def body(carry, x):
            s, acc, dacc = carry
            sx, weights = split_monitor_inputs(x, dft)
            s = step(s, sx)
            dacc, ys = apply_monitors(p, s, weights, dft, cells, dacc)
            if accumulate_power:
                inc = diagnostics.power_deposition(p, s, sigma)
                acc = acc + (inc * dt_step).astype(acc.dtype)
            return (s, acc, dacc), ys

        (s, acc, dacc), ys = jax.lax.scan(body, (s, power_acc, dft_acc), xs)
        return s, acc, dacc, ys

    return run
