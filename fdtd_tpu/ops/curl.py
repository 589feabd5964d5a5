"""Yee leapfrog curl updates as pure-jnp slice arithmetic.

These are the ground-truth ops (any backend, fp32/fp64): the semantics of the
reference's six triple loops (reference: main.c:431-462 update_H,
main.c:469-500 update_E) expressed as static-slice adds over the uniform
padded (k, j, i) arrays.  The E-update loop bounds start at 1 and stop before
max, which leaves tangential E on all six faces untouched — the implicit PEC
boundary (description.pdf section 2.1); the slice bounds below reproduce that
exactly, no masks needed.

XLA fuses the component updates into memory-bandwidth-bound passes over
device memory.
"""

from __future__ import annotations

from ..params import Params
from ..state import FieldState, UpdateCoefs


def _c(coef, slc):
    """Slice a coefficient if it is an array; pass scalars through."""
    return coef if isinstance(coef, (int, float)) else coef[slc]


def update_h(p: Params, s: FieldState, coefs: UpdateCoefs) -> FieldState:
    """Half-step H <- H + dt/(mu*dx) * curl E (reference: main.c:431-462).

    Loop bounds per component (k, j, i):
      Hx: k<K, j<J, i<I+1     Hy: k<K, j<J+1, i<I     Hz: k<K+1, j<J, i<I
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    # h_factor may be a traced scalar under vmap design sweeps (sweep.py)
    f = (
        s.ex.dtype.type(coefs.h_factor)
        if not hasattr(coefs.h_factor, "shape")
        else coefs.h_factor
    )
    ex, ey, ez = s.ex, s.ey, s.ez

    shx = (slice(0, K), slice(0, J), slice(0, I + 1))
    shy = (slice(0, K), slice(0, J + 1), slice(0, I))
    shz = (slice(0, K + 1), slice(0, J), slice(0, I))
    # heterogeneous mu_r: per-component face-averaged factors; scalar otherwise
    fx = coefs.hf_x[shx] if coefs.heterogeneous_mu else f
    fy = coefs.hf_y[shy] if coefs.heterogeneous_mu else f
    fz = coefs.hf_z[shz] if coefs.heterogeneous_mu else f

    hx = s.hx.at[shx].add(
        fx
        * (
            (ey[1 : K + 1, :J, : I + 1] - ey[:K, :J, : I + 1])
            - (ez[:K, 1 : J + 1, : I + 1] - ez[:K, :J, : I + 1])
        )
    )
    hy = s.hy.at[shy].add(
        fy
        * (
            (ez[:K, : J + 1, 1 : I + 1] - ez[:K, : J + 1, :I])
            - (ex[1 : K + 1, : J + 1, :I] - ex[:K, : J + 1, :I])
        )
    )
    hz = s.hz.at[shz].add(
        fz
        * (
            (ex[: K + 1, 1 : J + 1, :I] - ex[: K + 1, :J, :I])
            - (ey[: K + 1, :J, 1 : I + 1] - ey[: K + 1, :J, :I])
        )
    )
    return FieldState(s.ex, s.ey, s.ez, hx, hy, hz)


def update_e(p: Params, s: FieldState, coefs: UpdateCoefs) -> FieldState:
    """Half-step E <- ca*E + cb*curl H (reference: main.c:469-500).

    Interior-only bounds (the PEC boundary):
      Ex: k 1..K-1, j 1..J-1, i 0..I-1
      Ey: k 1..K-1, j 0..J-1, i 1..I-1
      Ez: k 0..K-1, j 1..J-1, i 1..I-1
    In vacuum ca==1, cb==dt/(EPSILON*dx); with materials ca/cb are padded
    arrays sliced over the same region (lossy update).
    """
    K, J, I = p.maxk, p.maxj, p.maxi
    hx, hy, hz = s.hx, s.hy, s.hz
    dt = s.ex.dtype

    sx = (slice(1, K), slice(1, J), slice(0, I))
    curl_x = (hz[1:K, 1:J, :I] - hz[1:K, 0 : J - 1, :I]) - (
        hy[1:K, 1:J, :I] - hy[0 : K - 1, 1:J, :I]
    )
    ex = s.ex.at[sx].set(
        (_c(coefs.ca_x, sx) * s.ex[sx] + _c(coefs.cb_x, sx) * curl_x).astype(dt)
    )

    sy = (slice(1, K), slice(0, J), slice(1, I))
    curl_y = (hx[1:K, :J, 1:I] - hx[0 : K - 1, :J, 1:I]) - (
        hz[1:K, :J, 1:I] - hz[1:K, :J, 0 : I - 1]
    )
    ey = s.ey.at[sy].set(
        (_c(coefs.ca_y, sy) * s.ey[sy] + _c(coefs.cb_y, sy) * curl_y).astype(dt)
    )

    sz = (slice(0, K), slice(1, J), slice(1, I))
    curl_z = (hy[:K, 1:J, 1:I] - hy[:K, 1:J, 0 : I - 1]) - (
        hx[:K, 1:J, 1:I] - hx[:K, 0 : J - 1, 1:I]
    )
    ez = s.ez.at[sz].set(
        (_c(coefs.ca_z, sz) * s.ez[sz] + _c(coefs.cb_z, sz) * curl_z).astype(dt)
    )

    return FieldState(ex, ey, ez, s.hx, s.hy, s.hz)
