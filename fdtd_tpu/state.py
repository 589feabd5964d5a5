"""Field state pytree, initial conditions, and material model.

Replaces the reference ``Fields`` struct of six malloc'd fp64 arrays
(reference: main.c:93-103, 294-364) with a JAX pytree of six device-resident
arrays of one uniform padded shape (see :mod:`fdtd_tpu.grid`).

Also adds the heterogeneous-material capability the reference lacks (it is
vacuum-only: scalar MU/EPSILON at main.c:441,479): per-cell relative
permittivity / conductivity / permeability, turned into per-component update
coefficients for the lossy E-update.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .constants import EPSILON, MU, PI
from .params import Params


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["ex", "ey", "ez", "hx", "hy", "hz"],
    meta_fields=[],
)
@dataclasses.dataclass
class FieldState:
    """The six Yee components, each of shape ``params.padded_shape``."""

    ex: jax.Array
    ey: jax.Array
    ez: jax.Array
    hx: jax.Array
    hy: jax.Array
    hz: jax.Array

    def astype(self, dtype) -> "FieldState":
        return jax.tree.map(lambda a: a.astype(dtype), self)


def field_dtype(p: Params):
    return jnp.dtype(p.dtype)


def zeros(p: Params, dtype=None) -> FieldState:
    """Zero-initialized fields (reference: main.c:294-364)."""
    dt = dtype or field_dtype(p)
    z = lambda: jnp.zeros(p.padded_shape, dtype=dt)
    return FieldState(z(), z(), z(), z(), z(), z())


def te101_initial_ey(p: Params) -> np.ndarray:
    """TE101 initial condition on Ey (reference: main.c:416-424).

    Ey[k,j,i] = sin(pi*k*dx/height) * sin(pi*i*dx/length) over Ey's full
    physical region (k 0..K, j 0..J-1, i 0..I); computed in fp64 then cast by
    the caller.
    """
    K1, J1, I1 = p.padded_shape
    dx = p.spatial_step
    k = np.arange(K1, dtype=np.float64) * dx
    i = np.arange(I1, dtype=np.float64) * dx
    prof = np.sin(PI * k / p.height)[:, None, None] * np.sin(PI * i / p.length)[None, None, :]
    ey = np.broadcast_to(prof, (K1, J1, I1)).copy()
    ey[:, p.maxj :, :] = 0.0  # padding: Ey physical j-extent is maxj
    return ey


def init_validation(p: Params, dtype=None) -> FieldState:
    """Zero fields with the TE101 Ey seed (validation mode init, main.c:843-844)."""
    st = zeros(p, dtype)
    ey = jnp.asarray(te101_initial_ey(p), dtype=st.ey.dtype)
    return dataclasses.replace(st, ey=ey)


# ---------------------------------------------------------------------------
# Materials (capability extension; reference is vacuum-only)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Materials:
    """Cell-centered material maps of shape (maxk, maxj, maxi).

    ``eps_r``: relative permittivity, ``sigma``: conductivity (S/m),
    ``mu_r``: relative permeability.  ``None`` means vacuum (scalar path —
    no coefficient arrays are materialized, keeping the vacuum hot loop at
    the reference's arithmetic).
    """

    eps_r: np.ndarray | None = None
    sigma: np.ndarray | None = None
    mu_r: np.ndarray | None = None

    @property
    def is_vacuum(self) -> bool:
        return self.eps_r is None and self.sigma is None and self.mu_r is None


def block_mask(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7)) -> np.ndarray:
    """Boolean cell mask of the fractional box [lo, hi) ((x, y, z)
    fractions) — the one geometry every load consumer (EM materials,
    thermal properties, the coupled driver) shares cell-for-cell."""
    K, J, I = p.maxk, p.maxj, p.maxi
    mask = np.zeros((K, J, I), dtype=bool)
    k0, j0, i0 = int(lo[2] * K), int(lo[1] * J), int(lo[0] * I)
    k1, j1, i1 = int(hi[2] * K), int(hi[1] * J), int(hi[0] * I)
    mask[k0:k1, j0:j1, i0:i1] = True
    return mask


def sphere_mask(p: Params, center=(0.5, 0.5, 0.5), radius=0.2) -> np.ndarray:
    """Boolean cell mask of a sphere: ``center`` in (x, y, z) fractional
    box coords, ``radius`` as a fraction of the box's shortest side.
    Cells are in when their center is inside — the staircase
    approximation standard for structured-grid FDTD."""
    K, J, I = p.maxk, p.maxj, p.maxi
    kc = (np.arange(K) + 0.5) / K
    jc = (np.arange(J) + 0.5) / J
    ic = (np.arange(I) + 0.5) / I
    # physical distances: fractional coords scaled by the box dimensions
    dims = np.array([p.length, p.width, p.height])
    r_phys = float(radius) * dims.min()
    dz = (kc - center[2])[:, None, None] * p.height
    dy = (jc - center[1])[None, :, None] * p.width
    dx = (ic - center[0])[None, None, :] * p.length
    return dx * dx + dy * dy + dz * dz <= r_phys * r_phys


def cylinder_mask(p: Params, center=(0.5, 0.5), radius=0.2,
                  lo=0.3, hi=0.7) -> np.ndarray:
    """Boolean cell mask of a z-axis cylinder (the mug of water):
    ``center`` in (x, y) fractions, ``radius`` as a fraction of the
    smaller transverse side, height spanning z fractions [lo, hi)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    jc = (np.arange(J) + 0.5) / J
    ic = (np.arange(I) + 0.5) / I
    r_phys = float(radius) * min(p.length, p.width)
    dy = (jc - center[1])[None, :, None] * p.width
    dx = (ic - center[0])[None, None, :] * p.length
    disk = dx * dx + dy * dy <= r_phys * r_phys
    kz = np.zeros((K, 1, 1), bool)
    kz[int(lo * K):int(hi * K)] = True
    return np.broadcast_to(disk & kz, (K, J, I)).copy()


def water_from_mask(p: Params, mask: np.ndarray, eps_r=78.0,
                    sigma=1.7) -> Materials:
    """Water/food material maps over an arbitrary boolean cell mask."""
    er = np.where(mask, float(eps_r), 1.0)
    sg = np.where(mask, float(sigma), 0.0)
    return Materials(eps_r=er, sigma=sg)


def water_block(p: Params, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7), eps_r=78.0, sigma=1.7) -> Materials:
    """A water/food block spanning fractional box coords [lo, hi) (BASELINE config #2)."""
    return water_from_mask(p, block_mask(p, lo, hi), eps_r, sigma)


def ferrite_slab(p: Params, base: Materials | None = None,
                 lo=(0.0, 0.0, 0.5), hi=(1.0, 0.5, 1.0),
                 mu_r=4.0) -> Materials:
    """A heterogeneous-``mu_r`` slab spanning fractional box coords
    [lo, hi) ((x, y, z) fractions, like :func:`water_block`), optionally
    layered on top of an existing scene (``base``) — e.g. a water block
    plus a ferrite shelf.  Capability extension over the vacuum-only
    reference (scalar ``MU``, main.c:441)."""
    K, J, I = p.maxk, p.maxj, p.maxi
    mu = np.ones((K, J, I))
    k0, j0, i0 = int(lo[2] * K), int(lo[1] * J), int(lo[0] * I)
    k1, j1, i1 = int(hi[2] * K), int(hi[1] * J), int(hi[0] * I)
    mu[k0:k1, j0:j1, i0:i1] = mu_r
    if base is None:
        return Materials(mu_r=mu)
    return dataclasses.replace(base, mu_r=mu)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z", "h_factor",
        "sigma_cells", "hf_x", "hf_y", "hf_z",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class UpdateCoefs:
    """Per-component E-update coefficients, and the H factor(s).

    Standard lossy-update form:  E <- ca*E + cb*(curl H)/dx  with
        ca = (1 - s) / (1 + s),   cb = (dt/(eps)) / (1 + s) / dx_applied_in_op
        s  = sigma*dt / (2*eps)
    In vacuum ca == 1 and cb == dt/(EPSILON*dx) — exactly the reference's
    ``factor`` (main.c:479).  ``ca_*``/``cb_*`` are either python scalars
    (vacuum) or padded arrays matching the component's update slice.

    ``h_factor`` is the scalar dt/(MU*dx) (reference main.c:441).  With
    heterogeneous ``mu_r``, ``hf_x/y/z`` carry per-component padded arrays
    dt/(MU*mu_face*dx), face-averaged at each H component's Yee location;
    they are None for uniform permeability (the common case — scalar hot
    loop preserved).
    """

    ca_x: object
    ca_y: object
    ca_z: object
    cb_x: object
    cb_y: object
    cb_z: object
    h_factor: object  # dt/(MU*dx) scalar
    sigma_cells: object | None = None  # cell-centered sigma for SAR diagnostics
    hf_x: object | None = None
    hf_y: object | None = None
    hf_z: object | None = None

    @property
    def heterogeneous_mu(self) -> bool:
        return self.hf_x is not None


def _edge_average(cells: np.ndarray, axis_pair: tuple[int, int]) -> np.ndarray:
    """Average cell-centered values onto E-edge locations.

    An E-edge along axis a is shared by the 4 cells adjacent in the other two
    axes; we pad with edge-replication at the boundary and average.
    Output shape: cells.shape + 1 along both axes in ``axis_pair``.
    """
    pads = [(0, 0)] * 3
    for ax in axis_pair:
        pads[ax] = (1, 1)
    padded = np.pad(cells, pads, mode="edge")
    out = padded
    for ax in axis_pair:
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[ax] = slice(0, -1)
        sl1[ax] = slice(1, None)
        out = 0.5 * (out[tuple(sl0)] + out[tuple(sl1)])
    return out


def update_coefs(p: Params, materials: Materials | None = None, dtype=None) -> UpdateCoefs:
    dt_ = p.time_step
    dx = p.spatial_step
    dty = dtype or field_dtype(p)

    if materials is None or materials.is_vacuum:
        cb = dt_ / (EPSILON * dx)  # reference main.c:479
        hf = dt_ / (MU * dx)  # reference main.c:441
        return UpdateCoefs(1.0, 1.0, 1.0, cb, cb, cb, hf, None)

    K, J, I = p.maxk, p.maxj, p.maxi
    er = materials.eps_r if materials.eps_r is not None else np.ones((K, J, I))
    sg = materials.sigma if materials.sigma is not None else np.zeros((K, J, I))

    def coefs_for(axis_pair, ext):
        # Edge-averaged eps and sigma at this component's E locations.
        eps_e = _edge_average(er, axis_pair) * EPSILON
        sig_e = _edge_average(sg, axis_pair)
        s = sig_e * dt_ / (2.0 * eps_e)
        ca = (1.0 - s) / (1.0 + s)
        cb = (dt_ / (eps_e * dx)) / (1.0 + s)
        # Embed into padded box (regions outside physical extent unused).
        K1, J1, I1 = p.padded_shape
        ca_p = np.ones((K1, J1, I1))
        cb_p = np.zeros((K1, J1, I1))
        ek, ej, ei = eps_e.shape
        ca_p[:ek, :ej, :ei] = ca
        cb_p[:ek, :ej, :ei] = cb
        return jnp.asarray(ca_p, dtype=dty), jnp.asarray(cb_p, dtype=dty)

    # Ex edges run along i → averaged over (k, j) = axes (0, 1); etc.
    ca_x, cb_x = coefs_for((0, 1), "ex")
    ca_y, cb_y = coefs_for((0, 2), "ey")
    ca_z, cb_z = coefs_for((1, 2), "ez")
    hf = dt_ / (MU * dx)

    hf_x = hf_y = hf_z = None
    if materials.mu_r is not None:
        # H components sit on cell faces: Hx on x-normal faces (average mu
        # over the two cells adjacent along i), Hy along j, Hz along k.
        mu = np.asarray(materials.mu_r, dtype=np.float64)

        def hf_for(axis):
            pads = [(0, 0)] * 3
            pads[axis] = (1, 1)
            padded = np.pad(mu, pads, mode="edge")
            sl0 = [slice(None)] * 3
            sl1 = [slice(None)] * 3
            sl0[axis] = slice(0, -1)
            sl1[axis] = slice(1, None)
            mu_face = 0.5 * (padded[tuple(sl0)] + padded[tuple(sl1)])
            K1, J1, I1 = p.padded_shape
            out = np.full((K1, J1, I1), hf)
            fk, fj, fi = mu_face.shape
            out[:fk, :fj, :fi] = dt_ / (MU * mu_face * dx)
            return jnp.asarray(out, dtype=dty)

        hf_x, hf_y, hf_z = hf_for(2), hf_for(1), hf_for(0)
    return UpdateCoefs(
        ca_x, ca_y, ca_z, cb_x, cb_y, cb_z, hf,
        jnp.asarray(sg, dtype=dty), hf_x, hf_y, hf_z,
    )
