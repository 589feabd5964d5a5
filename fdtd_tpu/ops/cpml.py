"""Convolutional PML (CPML) absorbing boundaries — capability extension.

The reference is a CLOSED PEC cavity: its E-update loop bounds leave
tangential E on all six faces untouched (reference: main.c:469-500,
description.pdf section 2.1), so waves reflect forever.  This module adds
the standard CPML outer absorber (Roden & Gedney, "Convolutional PML
(CPML): an efficient FDTD implementation of the CFS-PML for arbitrary
media", 2000; Taflove & Hagness ch. 7) so open-boundary problems —
radiation, ports, scattering — can run.  The PML is *backed by* the
existing implicit PEC wall, as is standard.

Formulation (kappa = 1, documented simplification): every spatial
difference Delta_w(u) feeding a curl gains a memory variable

    psi^{n+1} = b_w psi^n + c_w Delta_w(u)
    b_w = exp(-(sigma_w + alpha_w) dt / EPSILON)
    c_w = sigma_w / (sigma_w + alpha_w) * (b_w - 1)

and the field update adds f * psi (H pass) or cb * psi (E pass) on top of
the unchanged curl term.  sigma_w is graded polynomially over the
``cells``-deep slab at each face, sampled at each component's own
staggered position along the PML axis (integer for E, half-integer for
H); with kappa = 1 the interior update needs no 1/kappa scaling, so the
existing :mod:`fdtd_tpu.ops.curl` updates stay bit-identical and CPML is
a pure additive correction.  b = 1, c = 0 outside the slabs, so psi is
identically zero there and XLA's fused elementwise pass is the only
cost.

This is the single-device implementation (the sharded one is
:mod:`fdtd_tpu.parallel.sharded_step`, with the same arithmetic).  psi
arrays are SLAB-RESTRICTED (r3): each stores only the 2*cells rows of
its PML axis, so PML memory and per-step traffic scale with the PML
volume (~12*cells/N of the field state) instead of the 2x of a
full-shape layout, and the correction touches nothing outside the
slabs by construction.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import EPSILON, MU
from ..params import Params
from ..state import FieldState, UpdateCoefs
from .curl import _c

ETA0 = float(np.sqrt(MU / EPSILON))  # free-space impedance (~376.73 ohm)


@dataclasses.dataclass(frozen=True)
class PMLConfig:
    """CPML absorber configuration.

    ``cells``: slab depth at each of the six faces (10 is the standard
    sweet spot).  ``m``: polynomial grading order.  ``sigma_scale``:
    multiplies the textbook optimum sigma_max = 0.8 (m+1) / (eta0 dx).
    ``alpha``: CFS alpha (S/m), constant across the slab; 0 disables the
    complex-frequency shift (fine for propagating waves).
    """

    cells: int = 10
    m: float = 3.0
    sigma_scale: float = 1.0
    alpha: float = 0.0


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "hx_z", "hx_y", "hy_x", "hy_z", "hz_y", "hz_x",
        "ex_y", "ex_z", "ey_z", "ey_x", "ez_x", "ez_y",
    ],
    meta_fields=[],
)
@dataclasses.dataclass
class PsiState:
    """The 12 CPML memory variables, one per curl difference term.

    ``<comp>_<axis>`` is the psi for component ``comp``'s difference
    along ``axis``.  SLAB-RESTRICTED layout (r3): psi is nonzero only
    inside the two ``cells``-deep slabs along its axis, so each array
    stores exactly those rows — the component's update-region extents on
    the other two axes and ``2 * cells`` (lo slab then hi slab) along
    the PML axis.  Memory and per-step traffic scale with the PML
    volume, ~12 * cells / N of the field state, instead of the 2x of a
    full-shape layout.
    """

    hx_z: jax.Array
    hx_y: jax.Array
    hy_x: jax.Array
    hy_z: jax.Array
    hz_y: jax.Array
    hz_x: jax.Array
    ex_y: jax.Array
    ex_z: jax.Array
    ey_z: jax.Array
    ey_x: jax.Array
    ez_x: jax.Array
    ez_y: jax.Array


def _profile(pos: np.ndarray, extent: int, p: Params, cfg: PMLConfig):
    """(b, c) fp64 1-D CPML recursion coefficients at positions ``pos``.

    ``pos``: the component's coordinates along the PML axis in cell
    units (integer for E, half-integer for H).  ``extent``: the domain
    size along the axis (walls at 0 and extent).  Outside the two
    ``cfg.cells``-deep slabs sigma = 0 gives (b, c) = (1, 0).
    """
    d = np.maximum(cfg.cells - pos, pos - (extent - cfg.cells)) / cfg.cells
    d = np.clip(d, 0.0, 1.0)
    sigma_max = cfg.sigma_scale * 0.8 * (cfg.m + 1) / (ETA0 * p.spatial_step)
    sigma = sigma_max * d**cfg.m
    tot = sigma + cfg.alpha
    b = np.exp(-tot * p.time_step / EPSILON)
    with np.errstate(invalid="ignore", divide="ignore"):
        c = np.where(tot > 0.0, sigma / np.where(tot > 0, tot, 1.0) * (b - 1.0), 0.0)
    return b, c


# The 12 correction terms: (name, target, sign, pml_axis, src, e_pass).
# H terms difference src at +1 along the pml axis; E terms at -1.  Per
# target the j/i-axis terms precede the k-axis term — every path
# (single-device, sharded psi12, the dispersive ADE+CPML step) applies its
# adds in _TERMS order so corner cells round identically.
# (Where a target has two non-k terms, the +axis term keeps its
# original precedence over the -axis term.)
# Compat note (r5 reorder): moving the j/i adds ahead of the k add
# changes corner-cell ROUNDING vs pre-r5 builds — a checkpoint written
# by an older build resumes fine (psi is name-keyed, layout unchanged)
# but is no longer bit-equal to that build's uninterrupted run; within
# one build, resume stays bit-exact (pinned in test_pml).
_TERMS = (
    ("hx_y", "hx", -1, 1, "ez", False),
    ("hx_z", "hx", +1, 0, "ey", False),
    ("hy_x", "hy", +1, 2, "ez", False),
    ("hy_z", "hy", -1, 0, "ex", False),
    ("hz_y", "hz", +1, 1, "ex", False),
    ("hz_x", "hz", -1, 2, "ey", False),
    ("ex_y", "ex", +1, 1, "hz", True),
    ("ex_z", "ex", -1, 0, "hy", True),
    ("ey_x", "ey", -1, 2, "hz", True),
    ("ey_z", "ey", +1, 0, "hx", True),
    ("ez_x", "ez", +1, 2, "hy", True),
    ("ez_y", "ez", -1, 1, "hx", True),
)


def _update_regions(p: Params):
    """Array-coordinate update regions (the curl.py loop bounds)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    return {
        "hx": (slice(0, K), slice(0, J), slice(0, I + 1)),
        "hy": (slice(0, K), slice(0, J + 1), slice(0, I)),
        "hz": (slice(0, K + 1), slice(0, J), slice(0, I)),
        "ex": (slice(1, K), slice(1, J), slice(0, I)),
        "ey": (slice(1, K), slice(0, J), slice(1, I)),
        "ez": (slice(0, K), slice(1, J), slice(1, I)),
    }


def _slab_slices(region, axis, npml):
    """(lo, hi) sub-region 3-tuples: the npml rows at each end of the
    region along ``axis`` (the rows whose sigma can be nonzero)."""
    r = region[axis]
    lo, hi = list(region), list(region)
    lo[axis] = slice(r.start, r.start + npml)
    hi[axis] = slice(r.stop - npml, r.stop)
    return tuple(lo), tuple(hi)


def _check_cfg(p: Params, cfg: PMLConfig):
    K, J, I = p.maxk, p.maxj, p.maxi
    if cfg.cells < 1:
        raise ValueError("PML needs cells >= 1")
    if 2 * cfg.cells >= min(K, J, I):
        raise ValueError(
            f"PML slabs ({cfg.cells} cells/face) overlap: grid is "
            f"({K}, {J}, {I}) cells"
        )


def psi_shapes(p: Params, cfg: PMLConfig) -> dict[str, tuple[int, int, int]]:
    """The slab-restricted psi array shapes, computed host-side."""
    regions = _update_regions(p)
    shapes = {}
    for name, target, _sign, axis, _src, _e in _TERMS:
        shape = [s.stop - s.start for s in regions[target]]
        shape[axis] = 2 * cfg.cells
        shapes[name] = tuple(shape)
    return shapes


def init_psi(p: Params, cfg: PMLConfig, dtype=None) -> PsiState:
    """Zero memory variables in the slab-restricted layout."""
    _check_cfg(p, cfg)
    dt = jnp.dtype(dtype or p.dtype)
    return PsiState(
        **{n: jnp.zeros(sh, dt) for n, sh in psi_shapes(p, cfg).items()}
    )


def _shifted(sl, axis, d):
    out = list(sl)
    out[axis] = slice(sl[axis].start + d, sl[axis].stop + d)
    return tuple(out)


def build_plan(p: Params, cfg: PMLConfig, dt) -> dict:
    """Per-term correction plan shared by the CPML steps.

    ``{name: (lo_sl, hi_sl, sign, axis, src, target, b, c)}`` where
    lo_sl/hi_sl are the target's slab sub-regions in CANONICAL array
    coordinates and b/c are the (1-per-slab-row) recursion coefficient
    arrays broadcast-shaped along the PML axis."""
    npml = cfg.cells
    regions = _update_regions(p)
    extents = {0: p.maxk, 1: p.maxj, 2: p.maxi}
    plan = {}
    for name, target, sign, axis, src, e_pass in _TERMS:
        lo_sl, hi_sl = _slab_slices(regions[target], axis, npml)
        off = 0.0 if e_pass else 0.5
        pos = np.concatenate([
            np.arange(lo_sl[axis].start, lo_sl[axis].stop, dtype=np.float64),
            np.arange(hi_sl[axis].start, hi_sl[axis].stop, dtype=np.float64),
        ]) + off
        b, c = _profile(pos, extents[axis], p, cfg)
        shape = [1, 1, 1]
        shape[axis] = 2 * npml
        plan[name] = (
            lo_sl, hi_sl, sign, axis, src, target,
            jnp.asarray(b, dt).reshape(shape),
            jnp.asarray(c, dt).reshape(shape),
        )
    return plan


def make_cpml_corrections(p: Params, cfg: PMLConfig, coefs: UpdateCoefs,
                          dtype=None):
    """Build ``(h_correct, e_correct)`` closures.

    ``h_correct(state_after_update_h, psi) -> (state, psi)`` updates the
    six H-pass memory variables from the (unchanged) E fields and adds
    ``+-f * psi`` over the slab rows of each H component's update
    region; ``e_correct`` is the E-pass analogue adding ``+-cb * psi``.
    Correction-after-update is algebraically identical to the fused
    textbook form because the curl terms are untouched (kappa = 1).
    Everything outside the slabs is untouched — the correction is
    bit-inert there by construction, not just numerically.
    """
    _check_cfg(p, cfg)
    dt = jnp.dtype(dtype or p.dtype)
    npml = cfg.cells
    het = coefs.heterogeneous_mu
    # h_factor may be a traced scalar under vmap design sweeps (sweep.py)
    f_scalar = (
        dt.type(coefs.h_factor)
        if not hasattr(coefs.h_factor, "shape")
        else coefs.h_factor
    )

    plan = build_plan(p, cfg, dt)

    def _factor(target, sub, e_pass):
        if e_pass:
            return _c(getattr(coefs, f"cb_{target[1]}"), sub)
        if het:
            return getattr(coefs, f"hf_{target[1]}")[sub]
        return f_scalar

    def _apply(s: FieldState, psi: PsiState, e_pass: bool):
        # sources are never targets within a pass (H pass reads E, E
        # pass reads the just-updated H), so reading from `fields` —
        # which mutates targets only — always sees the right values
        fields = {n: getattr(s, n) for n in ("ex", "ey", "ez", "hx", "hy", "hz")}
        ups = {}
        for name, target, sign, axis, src, _e in [
            t for t in _TERMS if t[5] == e_pass
        ]:
            lo_sl, hi_sl, _sign, _axis, _src, _tg, b, c = plan[name]
            u = fields[src]
            if e_pass:
                d_lo = u[lo_sl] - u[_shifted(lo_sl, axis, -1)]
                d_hi = u[hi_sl] - u[_shifted(hi_sl, axis, -1)]
            else:
                d_lo = u[_shifted(lo_sl, axis, 1)] - u[lo_sl]
                d_hi = u[_shifted(hi_sl, axis, 1)] - u[hi_sl]
            diff = jnp.concatenate([d_lo, d_hi], axis=axis)
            pnew = b * getattr(psi, name) + c * diff
            ups[name] = pnew
            lo_p = lax.slice_in_dim(pnew, 0, npml, axis=axis)
            hi_p = lax.slice_in_dim(pnew, npml, 2 * npml, axis=axis)
            t = fields[target]
            t = t.at[lo_sl].add((sign * _factor(target, lo_sl, e_pass) * lo_p).astype(dt))
            t = t.at[hi_sl].add((sign * _factor(target, hi_sl, e_pass) * hi_p).astype(dt))
            fields[target] = t
        return (
            FieldState(fields["ex"], fields["ey"], fields["ez"],
                       fields["hx"], fields["hy"], fields["hz"]),
            dataclasses.replace(psi, **ups),
        )

    def h_correct(s: FieldState, psi: PsiState):
        return _apply(s, psi, e_pass=False)

    def e_correct(s: FieldState, psi: PsiState):
        return _apply(s, psi, e_pass=True)

    return h_correct, e_correct


def make_pml_step(p: Params, cfg: PMLConfig, coefs: UpdateCoefs):
    """One leapfrog step with CPML: ``step((state, psi), x) -> (state, psi)``.

    Same body order as :func:`fdtd_tpu.step.make_step` ([source] ->
    update_H [+ psi correction] -> [source] -> update_E [+ psi
    correction]), xla backend only.
    """
    from ..params import Mode
    from ..source import apply_source, make_source_plan
    from . import curl

    plan = make_source_plan(p) if p.mode == Mode.COMPUTATION else None
    h_correct, e_correct = make_cpml_corrections(p, cfg, coefs)

    def step(carry, x):
        s, psi = carry
        _t, amp = x
        if plan is not None:
            s = apply_source(plan, s, amp)
        s = curl.update_h(p, s, coefs)
        s, psi = h_correct(s, psi)
        if plan is not None:
            s = apply_source(plan, s, amp)
        s = curl.update_e(p, s, coefs)
        s, psi = e_correct(s, psi)
        return s, psi

    return step


def make_pml_chunk_runner(p: Params, cfg: PMLConfig, materials=None,
                          accumulate_power: bool = False,
                          dft=None, probes=None):
    """Jitted ``run((state, psi), xs, power) -> ((state, psi), power)``.

    The PML analogue of :func:`fdtd_tpu.step.make_chunk_runner` (xla
    semantics: no donation, canonical layout); SAR accumulation uses the
    per-step jnp increment.

    With ``dft``/``probes`` (per-step monitors — the open-boundary use
    cases: radiated phasor patterns, ring-down Q factors) the signature
    extends to ``run(carry, xs, power, dft_acc) -> (carry, power,
    dft_acc, probe_ys)`` with ``xs`` carrying the DFT weight rows, the
    same contract as
    :func:`fdtd_tpu.monitors.make_monitored_chunk_runner`.
    """
    import functools

    from ..state import update_coefs
    from .. import diagnostics

    coefs = update_coefs(p, materials)
    step = make_pml_step(p, cfg, coefs)
    sigma = (
        np.asarray(coefs.sigma_cells) if coefs.sigma_cells is not None else 0.0
    )
    dt_step = p.time_step

    if dft is not None or probes is not None:
        from ..monitors import apply_monitors, split_monitor_inputs

        if probes is not None:
            probes.validate(p)
        cells = probes.cells if probes is not None else None

        @jax.jit
        def run_mon(carry, xs, power_acc, dft_acc):
            def body(c, x):
                (s, psi), acc, dacc = c
                sx, weights = split_monitor_inputs(x, dft)
                s, psi = step((s, psi), sx)
                dacc, ys = apply_monitors(p, s, weights, dft, cells, dacc)
                if accumulate_power:
                    inc = diagnostics.power_deposition(p, s, sigma)
                    acc = acc + (inc * dt_step).astype(acc.dtype)
                return ((s, psi), acc, dacc), ys

            (carry, acc, dacc), ys = jax.lax.scan(
                body, (carry, power_acc, dft_acc), xs
            )
            return carry, acc, dacc, ys

        return run_mon

    @functools.partial(jax.jit)
    def run(carry, xs, power_acc=None):
        def body(c, x):
            (s, psi), acc = c
            s, psi = step((s, psi), x)
            if accumulate_power:
                inc = diagnostics.power_deposition(p, s, sigma)
                acc = acc + (inc * dt_step).astype(acc.dtype)
            return ((s, psi), acc), None

        (carry, acc), _ = jax.lax.scan(body, (carry, power_acc), xs)
        return carry, acc

    return run
