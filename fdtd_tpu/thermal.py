"""Thermal solve driven by the SAR map: the multi-rate EM -> heat coupling.

The product story the reference gestures at (a *microwave oven*
simulator, description.pdf section 1) but never implements: the EM run's
accumulated power deposition becomes the source term of a heat-diffusion
integration, answering "how hot does the food get, and where".

Multi-rate coupling: EM transients settle in nanoseconds while heating
takes seconds, so the EM run's time-averaged dissipated power density

    Q = power_acc / t_em      (W/m^3, power_acc in J/m^3 over t_em)

is taken constant over the thermal timescale — the standard CW
steady-state assumption.  Run the EM side long enough to reach the
driven steady state (a few cavity fill times) for Q to be meaningful.

Discretization: explicit FTCS on the same cell-centered (maxk, maxj,
maxi) grid as the SAR accumulator,

    rho_c dT/dt = div(k grad T) + Q

in flux form with *harmonic-mean* face conductivities (the physically
correct choice across material discontinuities: it makes the steady
two-slab interface flux exact) and insulated (zero-flux Neumann) walls.
The step is a 7-point stencil `lax.scan` — bandwidth-bound streaming
arithmetic, the same shape XLA fuses well; no custom kernel is
warranted at thermal step counts (~1e4-1e5 steps of
~0.5 GB traffic at 256^3, milliseconds each).

The stable step is computed per cell (variable coefficients):

    dt <= min over cells of  rho_c * dx^2 / sum_faces k_face

with a 0.9 safety factor.  Air cells next to a water load bind at
~1e-3 s for dx = 1 mm, so a 60 s cook is ~6e4 steps.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .params import Params

# volumetric heat capacity rho*c_p (J/m^3/K) and conductivity k (W/m/K)
AIR_RHO_C = 1.2 * 1005.0
AIR_K = 0.026
WATER_RHO_C = 1000.0 * 4186.0
WATER_K = 0.6


@dataclasses.dataclass(frozen=True)
class ThermalMaterials:
    """Cell-centered thermal property maps of shape (maxk, maxj, maxi).

    ``rho_c``: volumetric heat capacity rho*c_p (J/m^3/K); ``k``:
    thermal conductivity (W/m/K).
    """

    rho_c: np.ndarray
    k: np.ndarray


def air_thermal(p: Params) -> ThermalMaterials:
    shape = (p.maxk, p.maxj, p.maxi)
    return ThermalMaterials(
        rho_c=np.full(shape, AIR_RHO_C), k=np.full(shape, AIR_K)
    )


def thermal_from_mask(p: Params, mask, rho_c: float = WATER_RHO_C,
                      k: float = WATER_K,
                      base: ThermalMaterials | None = None) -> ThermalMaterials:
    """Water/food thermal properties over an arbitrary boolean cell mask
    (air elsewhere) — the mask-shaped sibling of :func:`water_thermal`,
    shared by the coupled driver and the CLI's --load-shape geometries."""
    tm = base if base is not None else air_thermal(p)
    import numpy as _np

    return ThermalMaterials(
        rho_c=_np.where(mask, rho_c, tm.rho_c),
        k=_np.where(mask, k, tm.k),
    )


def water_thermal(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7),
                  base: ThermalMaterials | None = None,
                  rho_c: float = WATER_RHO_C,
                  k: float = WATER_K) -> ThermalMaterials:
    """Water/food thermal properties over fractional box coords [lo, hi)
    — the same geometry convention as :func:`fdtd_tpu.state.water_block`,
    so the default load and its thermal map coincide cell for cell."""
    tm = base if base is not None else air_thermal(p)
    K, J, I = p.maxk, p.maxj, p.maxi
    k0, j0, i0 = int(lo[2] * K), int(lo[1] * J), int(lo[0] * I)
    k1, j1, i1 = int(hi[2] * K), int(hi[1] * J), int(hi[0] * I)
    rc = tm.rho_c.copy()
    kk = tm.k.copy()
    rc[k0:k1, j0:j1, i0:i1] = rho_c
    kk[k0:k1, j0:j1, i0:i1] = k
    return ThermalMaterials(rho_c=rc, k=kk)


def _face_k(k: np.ndarray, axis: int) -> np.ndarray:
    """Harmonic-mean conductivity on interior faces along ``axis``."""
    lo = np.take(k, range(k.shape[axis] - 1), axis=axis)
    hi = np.take(k, range(1, k.shape[axis]), axis=axis)
    s = lo + hi
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(s > 0, 2.0 * lo * hi / np.where(s > 0, s, 1.0), 0.0)


def stable_dt(p: Params, tm: ThermalMaterials, safety: float = 0.9) -> float:
    """Largest stable FTCS step: per-cell bound over the face sums."""
    dx2 = p.spatial_step**2
    ksum = np.zeros_like(tm.k)
    for axis in range(3):
        kf = _face_k(tm.k, axis)
        pad_lo = [(0, 0)] * 3
        pad_hi = [(0, 0)] * 3
        pad_lo[axis] = (1, 0)  # face (c-1, c) seen from cell c
        pad_hi[axis] = (0, 1)  # face (c, c+1)
        ksum += np.pad(kf, pad_lo) + np.pad(kf, pad_hi)
    # positivity-preserving (all update weights >= 0): dt <= rho_c dx^2
    # / sum_faces k_face — the classical dx^2/(6 alpha) for uniform k
    bound = tm.rho_c * dx2 / np.maximum(ksum, 1e-300)
    return float(safety * bound.min())


def make_thermal_step(p: Params, tm: ThermalMaterials, q, dt: float):
    """``step(T) -> T`` advancing one FTCS step (insulated walls).

    ``q``: (maxk, maxj, maxi) volumetric power density (W/m^3) — e.g.
    ``power_acc / t_em`` from an EM ``--sar`` run.

    The update is linear in ``T`` and a uniform constant carries zero
    flux through every face (including the insulated walls), so stepping
    an absolute temperature and stepping a rise above any uniform
    ambient are algebraically identical — :func:`run_thermal` exploits
    this to integrate the *rise*, whose leading digits are the signal,
    instead of an absolute field whose fp32 resolution at ~300 K
    (~2e-6 K) would swallow realistic per-step rises.
    """
    dx2 = p.spatial_step**2
    dtype = jnp.float32 if jnp.dtype(p.dtype) != jnp.float64 else jnp.float64
    inv_rc = jnp.asarray(dt / tm.rho_c, dtype)
    kfs = [jnp.asarray(_face_k(tm.k, axis), dtype) for axis in range(3)]
    q_term = jnp.asarray(np.asarray(q) * (dt / tm.rho_c), dtype)

    def step(T):
        div = jnp.zeros_like(T)
        for axis, kf in enumerate(kfs):
            n = T.shape[axis]
            lo = lax.slice_in_dim(T, 0, n - 1, axis=axis)
            hi = lax.slice_in_dim(T, 1, n, axis=axis)
            flux = kf * (hi - lo)  # k * dT across each interior face
            pad_in = [(0, 0)] * 3
            pad_out = [(0, 0)] * 3
            pad_in[axis] = (1, 0)
            pad_out[axis] = (0, 1)
            # div at cell c = flux(c, c+1) - flux(c-1, c) with
            # flux = k dT (so div is the discrete div(k grad T));
            # insulated walls: boundary faces carry zero flux (the pad)
            div = div + jnp.pad(flux, pad_out) - jnp.pad(flux, pad_in)
        return T + inv_rc * (div / dx2) + q_term

    return step


@dataclasses.dataclass
class ThermalResult:
    rise: jax.Array  # (maxk, maxj, maxi) rise above ambient, degrees K
    ambient: float
    dt: float
    steps: int

    @property
    def temperature(self) -> np.ndarray:
        """Absolute temperature (degrees C), reconstructed in fp64 on host.

        The integration carries the *rise* above the uniform ambient (see
        :func:`make_thermal_step`: the two are algebraically identical),
        so small rises keep their full compute-dtype resolution instead
        of being rounded against the ~300 K ambient magnitude.
        """
        return np.asarray(self.rise, np.float64) + self.ambient


def run_thermal(p: Params, tm: ThermalMaterials, q, duration: float,
                ambient: float = 20.0, dt: float | None = None,
                t0=None) -> ThermalResult:
    """Integrate the heat equation for ``duration`` seconds.

    ``q``: volumetric power density (W/m^3); ``t0``: initial temperature
    field (defaults to uniform ``ambient``).  The last step is shortened
    to land exactly on ``duration``.

    The state variable is the rise ``T - ambient`` (exactly equivalent:
    the update is linear and a uniform shift carries zero flux), and a
    ``float64`` ``p.dtype`` runs under :func:`jax.enable_x64` so the CLI
    honors ``--dtype float64`` without a process-global x64 flag.
    """
    if duration <= 0:
        raise ValueError("thermal duration must be positive")
    want64 = jnp.dtype(p.dtype) == jnp.float64
    if want64 and not jax.config.jax_enable_x64:
        with jax.enable_x64(True):
            return run_thermal(p, tm, q, duration, ambient=ambient,
                               dt=dt, t0=t0)
    dt_s = stable_dt(p, tm) if dt is None else float(dt)
    n_full = int(duration / dt_s)
    rem = duration - n_full * dt_s
    dtype = jnp.float64 if want64 else jnp.float32
    D = (jnp.zeros((p.maxk, p.maxj, p.maxi), dtype) if t0 is None
         else jnp.asarray(np.asarray(t0, np.float64) - ambient, dtype))
    q = np.asarray(q, np.float64)  # q*(dt/rho_c) forms in fp64 on host

    if n_full:
        step = make_thermal_step(p, tm, q, dt_s)

        @jax.jit
        def run(D):
            return lax.scan(lambda D, _: (step(D), None), D,
                            None, length=n_full)[0]

        D = run(D)
    do_rem = rem > 1e-12 * duration
    if do_rem:
        D = jax.jit(make_thermal_step(p, tm, q, rem))(D)
    return ThermalResult(rise=D, ambient=ambient, dt=dt_s,
                         steps=n_full + do_rem)
