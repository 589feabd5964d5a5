"""TE101 closed-form solution — the built-in correctness oracle.

Replicates the reference's validation evaluator (reference: main.c:670-710):
resonant frequency and wave impedance from *height*/length (main.c:672-675 —
yes, inconsistent with the source's width/length; reproduced faithfully), and
the three nonzero components of the TE101 mode:

    Ey =  cos(w t) sin(pi z/h) sin(pi x/l)
    Hx =  (1/Z_te) sin(w t) sin(pi z/h) cos(pi x/l)
    Hz = -pi/(w mu l) sin(w t) cos(pi z/h) sin(pi x/l)

The acceptance metric is the grid-relative L2 error
e_r = sqrt(sum (F_c - F_a)^2 / sum F_a^2) (description.pdf section 3 Eq. 2).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .constants import CELERITY, EPSILON, MU, PI
from .params import Params
from .state import FieldState


def mode_constants(p: Params) -> tuple[float, float]:
    """(f_101, Z_te) from height/length (reference: main.c:672-675)."""
    f_mnl = 0.5 * CELERITY * math.sqrt((PI / p.height) ** 2 + (PI / p.length) ** 2) / PI
    omega = 2.0 * PI * f_mnl
    z_te = (omega * MU) / math.sqrt(omega**2 * MU * EPSILON - (PI / p.length) ** 2)
    return f_mnl, z_te


def _spatial_profiles(p: Params):
    """fp64 numpy sin/cos profiles along k and i (static per Params)."""
    K1, J1, I1 = p.padded_shape
    dx = p.spatial_step
    kz = PI * np.arange(K1, dtype=np.float64) * dx / p.height
    kx = PI * np.arange(I1, dtype=np.float64) * dx / p.length
    return np.sin(kz), np.cos(kz), np.sin(kx), np.cos(kx)


def analytic_fields(p: Params, t: float, ccompat: bool = False) -> dict[str, np.ndarray]:
    """Closed-form Ey/Hx/Hz on their staggered grids at time ``t`` (fp64).

    Evaluated over the same loop regions as the reference (main.c:685-709);
    entries outside those regions are zero, matching the validation arrays.

    Physics (default, from Maxwell with Ey = cos(wt) sin(pi z/h) sin(pi x/l)):

        Hx =  (1/Z_te)      sin(wt) cos(pi z/h) sin(pi x/l)
        Hz = -(pi/(w mu l)) sin(wt) sin(pi z/h) cos(pi x/l)

    (note 1/Z_te == pi/(w mu h) exactly at the TE101 resonance).

    ``ccompat=True`` replicates the reference formulas verbatim instead
    (main.c:693-709), which have the sin/cos *spatial* factors of Hx and Hz
    swapped relative to the mode the reference's own update equations (and
    physics) produce — amplitudes are correct, profiles transposed.  Use it
    only for parity with the reference's aHx/aHz exports; the quality bar is
    measured against the default.  (Reference quirk; SURVEY section 2.4.)
    """
    f_mnl, z_te = mode_constants(p)
    omega = 2.0 * PI * f_mnl
    sin_kz, cos_kz, sin_kx, cos_kx = _spatial_profiles(p)
    K1, J1, I1 = p.padded_shape
    K, J, I = p.maxk, p.maxj, p.maxi
    ct = math.cos(2.0 * PI * f_mnl * t)
    st = math.sin(2.0 * PI * f_mnl * t)

    ey = np.zeros((K1, J1, I1))
    ey[:, :J, :] = ct * sin_kz[:, None, None] * sin_kx[None, None, :]

    hx = np.zeros((K1, J1, I1))
    hz = np.zeros((K1, J1, I1))
    if ccompat:
        hx[:K, :J, :] = (1.0 / z_te) * st * sin_kz[:K, None, None] * cos_kx[None, None, :]
        hz[:, :J, :I] = (-PI / (omega * MU * p.length)) * st * cos_kz[:, None, None] * sin_kx[None, None, :I]
    else:
        # Hx lives at (i, j+1/2, k+1/2): cos along z evaluated mid-cell.
        dz = PI * p.spatial_step / p.height
        dxs = PI * p.spatial_step / p.length
        cos_kz_half = np.cos(dz * (np.arange(K1) + 0.5))
        cos_kx_half = np.cos(dxs * (np.arange(I1) + 0.5))
        hx[:K, :J, :] = (1.0 / z_te) * st * cos_kz_half[:K, None, None] * sin_kx[None, None, :]
        hz[:, :J, :I] = (-PI / (omega * MU * p.length)) * st * sin_kz[:, None, None] * cos_kx_half[None, None, :I]

    return {"ey": ey, "hx": hx, "hz": hz}


def error_fields(p: Params, s: FieldState, t: float, ccompat: bool = True) -> dict[str, jnp.ndarray]:
    """(analytical - computed) for Ey/Hx/Hz (reference: main.c:685-709).

    Defaults to ``ccompat=True`` so exported aEy/aHx/aHz match the
    reference's Silo variables byte-for-semantics.
    """
    ana = analytic_fields(p, t, ccompat=ccompat)
    return {
        "aEy": jnp.asarray(ana["ey"], dtype=s.ey.dtype) - s.ey,
        "aHx": jnp.asarray(ana["hx"], dtype=s.hx.dtype) - s.hx,
        "aHz": jnp.asarray(ana["hz"], dtype=s.hz.dtype) - s.hz,
    }


def field_times(p: Params, t: float) -> dict[str, float]:
    """Each component's own time after the step whose time counter is ``t``.

    The reference's counter is the time *before* a step (main.c:765), so
    after that step E has advanced to t + dt and H to t + dt/2.  Starting
    from H(-dt/2) = 0 instead of the mode's own H(-dt/2) shifts the whole
    discrete mode by a further half step: Ey sits at t + 3 dt/2 and Hx, Hz
    at t + dt.  (tests/test_validation.py checks that these offsets, and
    no others on a dt/2 lattice, minimize e_r.)
    """
    dt_ = p.time_step
    return {"ey": t + 1.5 * dt_, "hx": t + dt_, "hz": t + dt_}


def own_time_error(p: Params, s: FieldState, t: float) -> dict[str, float]:
    """e_r per component (:func:`relative_l2_error`), each component against
    the analytic mode at its own time (:func:`field_times`) instead of at the
    time counter, which the leapfrog fields do not sit at."""
    times = field_times(p, t)
    return {name: relative_l2_error(p, s, tt)[name] for name, tt in times.items()}


def peak_normalized_error(p: Params, s: FieldState, t: float) -> dict[str, float]:
    """L2 error normalized by the mode's *peak* field norm, phase-compensated.

    The C-convention metric (:func:`relative_l2_error`) divides by the
    instantaneous analytic norm, which blows up near the mode's zero
    crossings; and discrete leapfrog fields are time-staggered
    (:func:`field_times`).  This metric compares each component against the
    analytic solution at its own discrete time and divides by the peak
    (envelope) norm, giving a physics-meaningful accuracy number at any
    phase.
    """
    times = field_times(p, t)
    out = {}
    for name, comp in (("ey", s.ey), ("hx", s.hx), ("hz", s.hz)):
        ana = analytic_fields(p, times[name])[name]
        peak = analytic_fields(p, _peak_time(p, name))[name]
        c = np.asarray(comp, dtype=np.float64)
        denom = float((peak * peak).sum())
        num = float(((c - ana) ** 2).sum())
        out[name] = math.sqrt(num / denom)
    return out


def _peak_time(p: Params, name: str) -> float:
    f_mnl, _ = mode_constants(p)
    period = 1.0 / f_mnl
    # ey peaks at t=0 (cos); hx/hz at quarter period (sin)
    return 0.0 if name == "ey" else period / 4.0


def relative_l2_error(p: Params, s: FieldState, t: float) -> dict[str, float]:
    """e_r per component (description.pdf section 3 Eq. 2), fp64 accumulation."""
    ana = analytic_fields(p, t)
    out = {}
    for name, comp in (("ey", s.ey), ("hx", s.hx), ("hz", s.hz)):
        a = ana[name]
        c = np.asarray(comp, dtype=np.float64)
        denom = float((a * a).sum())
        num = float(((c - a) ** 2).sum())
        out[name] = math.sqrt(num / denom) if denom > 0 else math.sqrt(num)
    return out
