"""On-device diagnostics: cavity energies and power deposition (SAR).

Energy replicates the reference's cell-centered means (reference:
main.c:602-668).  The reference has an indexing bug in the Ez term of the
electric energy — Ez is read through the *Hz* index map (main.c:627); the
default here is the physics-correct form, with ``quirk_compat=True``
replicating the buggy gather exactly for diagnostic parity (SURVEY
section 2.4 item 1).

All reductions run on device in fp32-or-better accumulation; results are tiny
scalars so host transfer is negligible.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .constants import EPSILON, MU
from .params import Params
from .state import FieldState


def _acc_dtype(x):
    return jnp.float64 if x.dtype == jnp.float64 else jnp.float32


def _cell_block(p: Params, kk=None, jj=None, ii=None):
    """Cell-index slices for the mean helpers (default: all cells)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    return (kk or slice(0, K), jj or slice(0, J), ii or slice(0, I))


def _sh(sl: slice, d: int) -> slice:
    return slice(sl.start + d, sl.stop + d)


def _e_cell_means(p: Params, s: FieldState, kk=None, jj=None, ii=None):
    """Cell-centered (mean_ex, mean_ey, mean_ez) over a cell block —
    mean over the 4 edges bordering each cell, per the reference index
    pattern (main.c:602-634).  Slicing before the arithmetic is exact,
    so a sub-block equals the same rows of the full-grid means."""
    kk, jj, ii = _cell_block(p, kk, jj, ii)
    at = _acc_dtype(s.ex)
    ex, ey, ez = s.ex.astype(at), s.ey.astype(at), s.ez.astype(at)
    k1, j1, i1 = _sh(kk, 1), _sh(jj, 1), _sh(ii, 1)
    mean_ex = 0.25 * (ex[kk, jj, ii] + ex[k1, jj, ii] + ex[kk, j1, ii] + ex[k1, j1, ii])
    mean_ey = 0.25 * (ey[kk, jj, ii] + ey[kk, jj, i1] + ey[k1, jj, ii] + ey[k1, jj, i1])
    mean_ez = 0.25 * (ez[kk, jj, ii] + ez[kk, j1, ii] + ez[kk, jj, i1] + ez[kk, j1, i1])
    return mean_ex, mean_ey, mean_ez


def _h_cell_means(p: Params, s: FieldState, kk=None, jj=None, ii=None):
    """Cell-centered (mean_hx, mean_hy, mean_hz) over a cell block —
    mean over the 2 faces bordering each cell (main.c:636-668)."""
    kk, jj, ii = _cell_block(p, kk, jj, ii)
    at = _acc_dtype(s.hx)
    hx, hy, hz = s.hx.astype(at), s.hy.astype(at), s.hz.astype(at)
    mean_hx = 0.5 * (hx[kk, jj, ii] + hx[kk, jj, _sh(ii, 1)])
    mean_hy = 0.5 * (hy[kk, jj, ii] + hy[kk, _sh(jj, 1), ii])
    mean_hz = 0.5 * (hz[kk, jj, ii] + hz[_sh(kk, 1), jj, ii])
    return mean_hx, mean_hy, mean_hz


def e_energy(p: Params, s: FieldState, quirk_compat: bool = False):
    """Total electric energy (reference: main.c:602-634)."""
    dv = p.spatial_step**3
    mean_ex, mean_ey, mean_ez = _e_cell_means(p, s)
    if quirk_compat:
        mean_ez = _quirk_mean_ez(p, s.ez.astype(_acc_dtype(s.ex)))

    total = (mean_ex**2).sum() + (mean_ey**2).sum() + (mean_ez**2).sum()
    return total * dv * (EPSILON / 2.0)


def _quirk_mean_ez(p: Params, ez):
    """Replicate main.c:627: Ez gathered through the kHz index map.

    kHz(i,j,k) = i + j*maxi + k*maxi*maxj, applied to the flat Ez buffer whose
    true strides are (maxi+1) and (maxi+1)*(maxj+1).  We flatten Ez's physical
    region in C order (identical memory layout to the reference buffer) and
    gather with the wrong strides, exactly as the C code does.
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    flat = ez[:K, : J + 1, : I + 1].reshape(-1)
    i = np.arange(I)[None, None, :]
    j = np.arange(J)[None, :, None]
    k = np.arange(K)[:, None, None]

    def khz(ii, jj, kk):
        return ii + jj * I + kk * I * J

    idx0 = khz(i, j, k)
    idx1 = khz(i, j + 1, k)
    idx2 = khz(i + 1, j, k)
    idx3 = khz(i + 1, j + 1, k)
    g = lambda idx: flat[jnp.asarray(np.broadcast_to(idx, (K, J, I)).ravel())]
    return (0.25 * (g(idx0) + g(idx1) + g(idx2) + g(idx3))).reshape(K, J, I)


def h_energy(p: Params, s: FieldState):
    """Total magnetic energy (reference: main.c:636-668)."""
    dv = p.spatial_step**3
    mean_hx, mean_hy, mean_hz = _h_cell_means(p, s)

    total = (mean_hx**2).sum() + (mean_hy**2).sum() + (mean_hz**2).sum()
    return total * dv * (MU / 2.0)


def total_energy(p: Params, s: FieldState, quirk_compat: bool = False):
    return e_energy(p, s, quirk_compat) + h_energy(p, s)


def theoretical_te101_energy(p: Params) -> float:
    """W = eps0 * a*b*d / 8 (description.pdf section 3 Eq. 4)."""
    return EPSILON * p.length * p.width * p.height / 8.0


def e_center_sq(p: Params, s: FieldState):
    """|E|^2 at cell centers: sum of squared 4-edge means per component."""
    mean_ex, mean_ey, mean_ez = _e_cell_means(p, s)
    return mean_ex**2 + mean_ey**2 + mean_ez**2


def poynting_flux(p: Params, s: FieldState, margin: int = 0):
    """Net outward Poynting flux (W) through an interior box.

    Capability extension for open-boundary (``--pml``) runs: the
    radiated power leaving the axis-aligned box whose faces lie
    ``margin`` cells inside the real grid on every side.  Uses the same
    cell-centered field means as the energy diagnostics (S = E x H at
    cell centers, summed over the box's outermost cell layer with
    outward normals); for a pulse fully inside the box the time
    integral matches the energy it radiates to a few percent (the
    leapfrog E/H half-step offset and the cell-centered S are both
    O(dx, dt) diagnostics, not conserved quantities).
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    m = int(margin)
    if not 0 <= m < min(K, J, I) // 2:
        raise ValueError(f"margin {margin} leaves no box in a ({K},{J},{I}) grid")
    kk = slice(m, K - m)
    jj = slice(m, J - m)
    ii = slice(m, I - m)

    # only the six one-cell face layers of S are needed — compute the
    # means per face (O(N^2)) instead of over the whole volume
    def s_face(comp, kf, jf, if_):
        mex, mey, mez = _e_cell_means(p, s, kf, jf, if_)
        mhx, mhy, mhz = _h_cell_means(p, s, kf, jf, if_)
        if comp == 0:
            return (mey * mhz - mez * mhy).sum()
        if comp == 1:
            return (mez * mhx - mex * mhz).sum()
        return (mex * mhy - mey * mhx).sum()

    one = lambda c: slice(c, c + 1)
    da = p.spatial_step**2
    flux = (
        s_face(2, one(K - 1 - m), jj, ii) - s_face(2, one(m), jj, ii)
        + s_face(1, kk, one(J - 1 - m), ii) - s_face(1, kk, one(m), ii)
        + s_face(0, kk, jj, one(I - 1 - m)) - s_face(0, kk, jj, one(m))
    )
    return flux * da


def power_deposition(p: Params, s: FieldState, sigma_cells):
    """Instantaneous dissipated power density sigma*|E|^2 (W/m^3) per cell.

    Capability extension (BASELINE config #3): the reference has no lossy
    media, so no SAR.  Accumulate this over steps (x dt) for heating maps;
    SAR = sigma*|E|^2 / rho for a density map rho.
    """
    return sigma_cells * e_center_sq(p, s)

