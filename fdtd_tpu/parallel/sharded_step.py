"""Explicit shard_map leapfrog step with ppermute halo exchange.

The device-mesh re-design of the reference's MPI parallel branch
(description.pdf section 2.2, Figs. 2-3): instead of 1-D Z slabs with
MPI_Isend/Recv ghost planes, the grid shards over a 1/2/3-D device mesh and
each step exchanges six one-cell planes per half-step as
``lax.ppermute`` shifts (collectives XLA hands to NCCL on GPUs) — E planes
travel toward -axis before the H update (H reads E at +1), H planes travel
toward +axis before the E update (E reads H at -1), the exact communication
pattern of the reference generalized to 3 axes.  There is no rank-0 output
gather: each shard's data streams independently (see fdtd_tpu.io).

PEC boundaries and staggered-extent bounds are enforced with global-index
masks computed from ``lax.axis_index`` + iota — rank-local constants that
XLA folds into the fused update.

A GSPMD alternative (jit + sharding constraints on the single-device code,
letting XLA insert the collectives) is in :mod:`fdtd_tpu.parallel.gspmd`;
both produce identical fields, and the explicit version is the one with
hand-controlled comm scheduling.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import EPSILON, MU
from ..params import Mode, Params
from ..source import make_source_plan
from ..state import FieldState
from .mesh import AXES, field_sharding, padded_divisible_shape


def _source_pattern(p: Params, shape_ji: tuple[int, int], dtype) -> tuple[np.ndarray, np.ndarray]:
    """Global (Jp, Ip) profile and mask arrays for the z=0 source patch."""
    Jp, Ip = shape_ji
    prof = np.zeros((Jp, Ip), dtype=np.float64)
    mask = np.zeros((Jp, Ip), dtype=bool)
    if p.mode == Mode.COMPUTATION:
        plan = make_source_plan(p)
        prof[plan.j0 : plan.j1, plan.i0 : plan.i1] = np.asarray(plan.profile)[None, :]
        mask[plan.j0 : plan.j1, plan.i0 : plan.i1] = True
    return prof.astype(dtype), mask


def _grid_ops(mesh: Mesh, lsz: dict):
    """(shift_up, shift_down, gindex) halo/index helpers for a rank-local
    block: one-plane ppermute exchanges over the mesh axes and the
    global-index iota used by the staggered/PEC masks.  Shared by the
    standard and dispersive sharded steps so the two cannot diverge."""
    nsh = {i: mesh.shape[a] for i, a in enumerate(AXES)}

    def shift_up(x, dim):
        """xp[l] = x[global l+1]; zero beyond the global top (masked there)."""
        n = nsh[dim]
        rest = lax.slice_in_dim(x, 1, None, axis=dim)
        first = lax.slice_in_dim(x, 0, 1, axis=dim)
        if n > 1:
            recv = lax.ppermute(first, AXES[dim], [(r, r - 1) for r in range(1, n)])
        else:
            recv = jnp.zeros_like(first)
        return jnp.concatenate([rest, recv], axis=dim)

    def shift_down(x, dim):
        """xm[l] = x[global l-1]; zero below 0 (masked there)."""
        n = nsh[dim]
        rest = lax.slice_in_dim(x, 0, -1, axis=dim)
        last = lax.slice_in_dim(x, -1, None, axis=dim)
        if n > 1:
            recv = lax.ppermute(last, AXES[dim], [(r, r + 1) for r in range(n - 1)])
        else:
            recv = jnp.zeros_like(last)
        return jnp.concatenate([recv, rest], axis=dim)

    def gindex(local_shape, dim):
        r = lax.axis_index(AXES[dim])
        io = lax.broadcasted_iota(jnp.int32, local_shape, dim)
        return io + r * lsz[dim]

    return shift_up, shift_down, gindex


def make_sharded_step(p: Params, mesh: Mesh, materials=None, pml=None,
                      accumulate_power: bool = False):
    """Build ``sharded_step(amp, state) -> state``.

    Operates on fields of the mesh-divisible global shape (see
    ``pad_state_for_mesh``).  With ``materials``, the E update uses sharded
    ca/cb coefficient slabs (lossy media) and — for heterogeneous mu_r — the
    H update uses sharded per-component face-averaged factors; both are
    device-put once here and closed over as sharded constants.

    With ``pml`` (a :class:`fdtd_tpu.ops.cpml.PMLConfig`): the CPML psi
    memory variables ride the step as 12 extra sharded (Kp, Jp, Ip)
    arrays and the signature becomes ``sharded_step(amp, state, psi12)
    -> (state, psi12)``.  The correction is the same additive kappa=1
    form as the single-chip :mod:`fdtd_tpu.ops.cpml`: the 1-D (b, c)
    recursion profiles are replicated and sliced per shard at the
    rank's global offset, the psi updates reuse the very same halo-
    exchanged differences the curl updates consumed, and the correction
    applies under the same global-index masks — outside the slabs
    (b, c) = (1, 0) keeps psi identically zero.

    With ``accumulate_power`` (SAR, needs lossy ``materials``): a sharded
    (Kp, Jp, Ip) float32 accumulator rides the step as the LAST argument
    and return value; each step adds sigma |E|^2 dt from the post-E-pass
    fields with cell-centered means built from the same halo shifts the
    curls use — element-for-element the arithmetic of the single-chip
    :func:`fdtd_tpu.diagnostics.power_deposition` path, so the cropped
    accumulator is bit-equal to an unsharded run's.  Composes with
    ``pml`` (the signature gains both extras, psi12 before acc).
    """
    from ..state import update_coefs

    if p.mode == Mode.COMPUTATION:
        plan = make_source_plan(p)
        inv_z_te = plan.inv_z_te
    else:
        inv_z_te = 0.0

    K, J, I = p.maxk, p.maxj, p.maxi
    Kp, Jp, Ip = padded_divisible_shape(p, mesh)
    nz, ny, nx = (mesh.shape[a] for a in AXES)
    Lk, Lj, Li = Kp // nz, Jp // ny, Ip // nx
    dtype = jnp.dtype(p.dtype)
    f_h = dtype.type(p.time_step / (MU * p.spatial_step))
    f_e = dtype.type(p.time_step / (EPSILON * p.spatial_step))
    computation = p.mode == Mode.COMPUTATION

    coefs = update_coefs(p, materials)
    lossy = not isinstance(coefs.ca_x, (int, float))
    het_mu = coefs.heterogeneous_mu
    fsh = field_sharding(mesh)
    K1, J1, I1 = p.padded_shape

    def padc(a):
        a = jnp.pad(jnp.asarray(a, dtype), ((0, Kp - K1), (0, Jp - J1), (0, Ip - I1)))
        return jax.device_put(a, fsh)

    coef_arrays = []
    if lossy:
        coef_arrays += [padc(getattr(coefs, n)) for n in
                        ("ca_x", "ca_y", "ca_z", "cb_x", "cb_y", "cb_z")]
    if het_mu:
        coef_arrays += [padc(getattr(coefs, n)) for n in ("hf_x", "hf_y", "hf_z")]
    if accumulate_power:
        if coefs.sigma_cells is None:
            raise NotImplementedError("power accumulation needs lossy materials")
        # keep sigma's own (fp64) dtype: the single-chip increment is
        # sigma_fp64 * means_fp32 -> fp64, then cast into the fp32 acc
        sg_np = np.asarray(coefs.sigma_cells)
        sg_pad = np.zeros((Kp, Jp, Ip), sg_np.dtype)
        sg_pad[: sg_np.shape[0], : sg_np.shape[1], : sg_np.shape[2]] = sg_np
        coef_arrays.append(jax.device_put(jnp.asarray(sg_pad), fsh))
    dt_step = p.time_step

    if pml is not None:
        from ..ops.cpml import _profile

        if 2 * pml.cells >= min(K, J, I):
            raise ValueError(
                f"PML slabs ({pml.cells} cells/face) overlap: grid is "
                f"({K}, {J}, {I}) cells"
            )

        # 1-D recursion profiles over the PADDED global extents; positions
        # beyond the real grid get sigma = 0 -> (b, c) = (1, 0), so psi
        # stays zero in the pad region.  Replicated; sliced per shard.
        def prof1d(n_pos, offset, extent):
            pos = np.arange(n_pos, dtype=np.float64) + offset
            pos = np.where(pos <= extent, pos, np.float64(-1.0))  # pad: sigma=0
            b, c = _profile(pos, extent, p, pml)
            c = np.where(pos < 0, 0.0, c)
            rep = NamedSharding(mesh, P())
            return (jax.device_put(jnp.asarray(b, dtype), rep),
                    jax.device_put(jnp.asarray(c, dtype), rep))

        pml_profiles = [
            prof1d(Kp, 0.5, K), prof1d(Jp, 0.5, J), prof1d(Ip, 0.5, I),  # H
            prof1d(Kp, 0.0, K), prof1d(Jp, 0.0, J), prof1d(Ip, 0.0, I),  # E
        ]

    prof_np, mask_np = _source_pattern(p, (Jp, Ip), dtype)
    src_sh = NamedSharding(mesh, P("y", "x"))
    prof = jax.device_put(jnp.asarray(prof_np), src_sh)
    msrc = jax.device_put(jnp.asarray(mask_np), src_sh)

    lsz = {0: Lk, 1: Lj, 2: Li}
    shift_up, shift_down, gindex = _grid_ops(mesh, lsz)

    def local_step(amp, ex, ey, ez, hx, hy, hz, prof_l, msrc_l, *cf):
        # cf layout: [lossy ca/cb x6] [het hf x3] [sigma] [prof12] [psi12] [acc]
        if accumulate_power:
            acc = cf[-1]
            cf = cf[:-1]
        if pml is not None:
            psi12 = cf[-12:]
            prof12 = cf[-24:-12]
            cf = cf[:-24]
        if accumulate_power:
            sg_l = cf[-1]
            cf = cf[:-1]
        if pml is not None:

            def locp(b_g, c_g, dim):
                r = lax.axis_index(AXES[dim])
                shape = [1, 1, 1]
                shape[dim] = lsz[dim]
                return tuple(
                    lax.dynamic_slice(g, (r * lsz[dim],), (lsz[dim],)).reshape(shape)
                    for g in (b_g, c_g)
                )

            bz_h, cz_h = locp(prof12[0], prof12[1], 0)
            by_h, cy_h = locp(prof12[2], prof12[3], 1)
            bx_h, cx_h = locp(prof12[4], prof12[5], 2)
            bz_e, cz_e = locp(prof12[6], prof12[7], 0)
            by_e, cy_e = locp(prof12[8], prof12[9], 1)
            bx_e, cx_e = locp(prof12[10], prof12[11], 2)
        if lossy:
            cax, cay, caz, cbx, cby, cbz = cf[:6]
        if het_mu:
            hfx, hfy, hfz = cf[6:] if lossy else cf[:3]
        shp = ex.shape
        gz = gindex(shp, 0)
        gy = gindex(shp, 1)
        gx = gindex(shp, 2)

        def inject(ex, ez, hx, hz):
            m = (gz == 0) & msrc_l[None, :, :]
            drive = (amp * prof_l[None, :, :]).astype(dtype)
            ez = jnp.where(m, drive, ez)
            ex = jnp.where(m, dtype.type(0), ex)
            hz = jnp.where(m, dtype.type(0), hz)
            hx = jnp.where(m, (-inv_z_te) * drive, hx)
            return ex, ez, hx, hz

        if computation:
            ex, ez, hx, hz = inject(ex, ez, hx, hz)

        # --- H half-step: needs E at +1 (planes from the next rank) ---
        ey_pz = shift_up(ey, 0)
        ey_px = shift_up(ey, 2)
        ez_py = shift_up(ez, 1)
        ez_px = shift_up(ez, 2)
        ex_pz = shift_up(ex, 0)
        ex_py = shift_up(ex, 1)

        m_hx = (gz < K) & (gy < J) & (gx < I + 1)
        m_hy = (gz < K) & (gy < J + 1) & (gx < I)
        m_hz = (gz < K + 1) & (gy < J) & (gx < I)
        fhx = hfx if het_mu else f_h
        fhy = hfy if het_mu else f_h
        fhz = hfz if het_mu else f_h
        hx = jnp.where(m_hx, hx + fhx * ((ey_pz - ey) - (ez_py - ez)), hx)
        hy = jnp.where(m_hy, hy + fhy * ((ez_px - ez) - (ex_pz - ex)), hy)
        hz = jnp.where(m_hz, hz + fhz * ((ex_py - ex) - (ey_px - ey)), hz)

        if pml is not None:
            # CPML H-pass correction (same additive kappa=1 form and
            # ordering as ops.cpml.h_correct: psi from the exact same
            # differences, f*psi added over the same component regions)
            p_hx_y, p_hx_z, p_hy_x, p_hy_z, p_hz_y, p_hz_x = psi12[:6]
            p_hx_y = by_h * p_hx_y + cy_h * (ez_py - ez)
            p_hx_z = bz_h * p_hx_z + cz_h * (ey_pz - ey)
            p_hy_x = bx_h * p_hy_x + cx_h * (ez_px - ez)
            p_hy_z = bz_h * p_hy_z + cz_h * (ex_pz - ex)
            p_hz_y = by_h * p_hz_y + cy_h * (ex_py - ex)
            p_hz_x = bx_h * p_hz_x + cx_h * (ey_px - ey)
            # two sequential adds per component (j/i-axis term first),
            # the exact rounding order of the slab-restricted
            # single-chip path (ops.cpml._TERMS) — outside the slabs
            # psi == 0 and x + f*0 is exact, so non-slab cells are
            # bit-untouched
            hx = jnp.where(m_hx, hx - fhx * p_hx_y, hx)
            hx = jnp.where(m_hx, hx + fhx * p_hx_z, hx)
            hy = jnp.where(m_hy, hy + fhy * p_hy_x, hy)
            hy = jnp.where(m_hy, hy - fhy * p_hy_z, hy)
            hz = jnp.where(m_hz, hz + fhz * p_hz_y, hz)
            hz = jnp.where(m_hz, hz - fhz * p_hz_x, hz)

        if computation:
            ex, ez, hx, hz = inject(ex, ez, hx, hz)

        # --- E half-step: needs H at -1 (planes from the previous rank) ---
        hz_my = shift_down(hz, 1)
        hy_mz = shift_down(hy, 0)
        hx_mz = shift_down(hx, 0)
        hz_mx = shift_down(hz, 2)
        hy_mx = shift_down(hy, 2)
        hx_my = shift_down(hx, 1)

        m_ex = (gz >= 1) & (gz < K) & (gy >= 1) & (gy < J) & (gx < I)
        m_ey = (gz >= 1) & (gz < K) & (gy < J) & (gx >= 1) & (gx < I)
        m_ez = (gz < K) & (gy >= 1) & (gy < J) & (gx >= 1) & (gx < I)
        curl_x = (hz - hz_my) - (hy - hy_mz)
        curl_y = (hx - hx_mz) - (hz - hz_mx)
        curl_z = (hy - hy_mx) - (hx - hx_my)
        if lossy:
            ex = jnp.where(m_ex, cax * ex + cbx * curl_x, ex)
            ey = jnp.where(m_ey, cay * ey + cby * curl_y, ey)
            ez = jnp.where(m_ez, caz * ez + cbz * curl_z, ez)
        else:
            ex = jnp.where(m_ex, ex + f_e * curl_x, ex)
            ey = jnp.where(m_ey, ey + f_e * curl_y, ey)
            ez = jnp.where(m_ez, ez + f_e * curl_z, ez)

        if pml is not None:
            # CPML E-pass correction (ops.cpml.e_correct): psi from the
            # post-H-update differences, cb*psi added under the E masks
            p_ex_y, p_ex_z, p_ey_x, p_ey_z, p_ez_x, p_ez_y = psi12[6:]
            p_ex_y = by_e * p_ex_y + cy_e * (hz - hz_my)
            p_ex_z = bz_e * p_ex_z + cz_e * (hy - hy_mz)
            p_ey_x = bx_e * p_ey_x + cx_e * (hz - hz_mx)
            p_ey_z = bz_e * p_ey_z + cz_e * (hx - hx_mz)
            p_ez_x = bx_e * p_ez_x + cx_e * (hy - hy_mx)
            p_ez_y = by_e * p_ez_y + cy_e * (hx - hx_my)
            gx_cb = cbx if lossy else f_e
            gy_cb = cby if lossy else f_e
            gz_cb = cbz if lossy else f_e
            # same sequential-add rounding order as ops.cpml._TERMS
            ex = jnp.where(m_ex, ex + gx_cb * p_ex_y, ex)
            ex = jnp.where(m_ex, ex - gx_cb * p_ex_z, ex)
            ey = jnp.where(m_ey, ey - gy_cb * p_ey_x, ey)
            ey = jnp.where(m_ey, ey + gy_cb * p_ey_z, ey)
            ez = jnp.where(m_ez, ez + gz_cb * p_ez_x, ez)
            ez = jnp.where(m_ez, ez - gz_cb * p_ez_y, ez)

        if accumulate_power:
            # SAR increment from the post-E-pass fields: cell-centered
            # 4-edge means via the same halo shifts the curls use, in
            # the exact add order of diagnostics._e_cell_means, sigma in
            # its own (fp64) dtype — bit-equal to the single-chip
            # power_deposition accumulation.  Pad cells have sigma = 0.
            at = jnp.float64 if dtype == jnp.float64 else jnp.float32
            exa, eya, eza = ex.astype(at), ey.astype(at), ez.astype(at)
            mean_ex = 0.25 * (exa + shift_up(exa, 0) + shift_up(exa, 1)
                              + shift_up(shift_up(exa, 0), 1))
            mean_ey = 0.25 * (eya + shift_up(eya, 2) + shift_up(eya, 0)
                              + shift_up(shift_up(eya, 0), 2))
            mean_ez = 0.25 * (eza + shift_up(eza, 1) + shift_up(eza, 2)
                              + shift_up(shift_up(eza, 1), 2))
            inc = sg_l * (mean_ex**2 + mean_ey**2 + mean_ez**2)
            acc = acc + (inc * dt_step).astype(acc.dtype)

        out = [ex, ey, ez, hx, hy, hz]
        if pml is not None:
            out += [p_hx_y, p_hx_z, p_hy_x, p_hy_z, p_hz_y, p_hz_x,
                    p_ex_y, p_ex_z, p_ey_x, p_ey_z, p_ez_x, p_ez_y]
        if accumulate_power:
            out.append(acc)
        return tuple(out) if len(out) > 6 else (ex, ey, ez, hx, hy, hz)

    fspec = P(*AXES)
    in_specs = (P(), fspec, fspec, fspec, fspec, fspec, fspec,
                P("y", "x"), P("y", "x")) + (fspec,) * len(coef_arrays)
    n_out = 6
    if pml is not None:
        prof_flat = [a for pair in pml_profiles for a in pair]
        in_specs += (P(),) * 12 + (fspec,) * 12
        n_out += 12
    if accumulate_power:
        in_specs += (fspec,)
        n_out += 1
    smap = jax.shard_map(
        local_step, mesh=mesh, in_specs=in_specs, out_specs=(fspec,) * n_out
    )

    def sharded_step(amp, s: FieldState, *extra):
        """(amp, state[, psi12][, acc]) -> (state[, psi12][, acc])."""
        args = [amp, s.ex, s.ey, s.ez, s.hx, s.hy, s.hz, prof, msrc,
                *coef_arrays]
        if pml is not None:
            args += [*prof_flat, *extra[0]]
        if accumulate_power:
            args.append(extra[-1])
        outs = smap(*args)
        res = [FieldState(*outs[:6])]
        if pml is not None:
            res.append(tuple(outs[6:18]))
        if accumulate_power:
            res.append(outs[-1])
        return res[0] if len(res) == 1 else tuple(res)

    if pml is not None:
        sharded_step.zero_psi = lambda: tuple(
            jax.device_put(jnp.zeros((Kp, Jp, Ip), dtype), fsh)
            for _ in range(12)
        )
    return sharded_step


def make_sharded_monitored_chunk_runner(p: Params, mesh: Mesh,
                                       materials=None, pml=None,
                                       accumulate_power: bool = False,
                                       dft=None, probes=None):
    """``run(carry, xs, power, dft_acc) -> (carry, power, dft_acc,
    probe_ys)`` — every non-dispersive ``--shard`` composition in one scan,
    with the monitored-chunk contract of
    :func:`fdtd_tpu.monitors.make_monitored_chunk_runner`.

    ``carry`` is the mesh-padded state, or ``(state, psi12)`` with ``pml``
    (``run.zero_psi()`` builds the zero psi12).  ``power`` is the sharded
    padded accumulator or None; ``dft_acc`` is None without a DFT.  The
    monitors read the padded state: the cell-mean slices never reach the
    pad region."""
    from ..monitors import apply_monitors, split_monitor_inputs

    step = make_sharded_step(p, mesh, materials, pml=pml,
                             accumulate_power=accumulate_power)
    if probes is not None:
        probes.validate(p)
    cells = probes.cells if probes is not None else None

    @jax.jit
    def run(carry, xs, power_acc, dft_acc):
        def body(c, x):
            carry, acc, dacc = c
            (_t, amp), weights = split_monitor_inputs(x, dft)
            s = carry[0] if pml is not None else carry
            extras = (((carry[1],) if pml is not None else ())
                      + ((acc,) if accumulate_power else ()))
            outs = step(amp, s, *extras)
            if extras:
                s, *rest = outs
                if pml is not None:
                    carry = (s, rest.pop(0))
                if accumulate_power:
                    acc = rest.pop(0)
            else:
                s = outs
            if pml is None:
                carry = s
            dacc, ys = apply_monitors(p, s, weights, dft, cells, dacc)
            return (carry, acc, dacc), ys

        (carry, acc, dacc), ys = lax.scan(
            body, (carry, power_acc, dft_acc), xs
        )
        return carry, acc, dacc, ys

    if pml is not None:
        run.zero_psi = step.zero_psi
    return run


def make_sharded_dispersive_step(p: Params, mesh: Mesh, dm,
                                 accumulate_power: bool = False):
    """``step(amp, state, (px, py, pz)[, acc]) -> (state, P[, acc])`` —
    the ADE Debye update (:mod:`fdtd_tpu.ops.dispersive`) under spatial
    sharding, lifting round 3's single-chip-only restriction.

    The three polarization arrays shard exactly like the fields (they
    live on the same padded E grids and join the scan carry); the five
    ADE coefficient maps per component plus the edge sigma are sharded
    constants.  P needs NO halo exchange of its own: the ADE update is
    pointwise in P (only curl H is non-local, and those planes are the
    same six ppermute shifts the standard E half-step uses).  With
    ``accumulate_power`` the accumulator collects the TRUE Debye work
    E_mid (dP/dt + sigma E_mid) cell-centered with the exact slice
    association of :func:`fdtd_tpu.ops.dispersive.work_cell_means` — so
    the cropped accumulator is bit-equal to the single-chip ADE scan's.

    H half-step: vacuum factor dt/(MU dx) — DebyeMaterials rejects
    heterogeneous mu_r (ops/dispersive.debye_coefs).
    """
    from ..ops.dispersive import debye_coefs

    if p.mode != Mode.COMPUTATION:
        raise ValueError("dispersive media run in computation mode")
    plan = make_source_plan(p)
    inv_z_te = plan.inv_z_te

    K, J, I = p.maxk, p.maxj, p.maxi
    Kp, Jp, Ip = padded_divisible_shape(p, mesh)
    nz, ny, nx = (mesh.shape[a] for a in AXES)
    lsz = {0: Kp // nz, 1: Jp // ny, 2: Ip // nx}
    dtype = jnp.dtype(p.dtype)
    dc = debye_coefs(p, dm)
    f_h = dtype.type(float(np.asarray(dc.h_factor)))
    dt_step = p.time_step
    fsh = field_sharding(mesh)
    K1, J1, I1 = p.padded_shape

    def padc(a):
        a = jnp.pad(jnp.asarray(a, dtype),
                    ((0, Kp - K1), (0, Jp - J1), (0, Ip - I1)))
        return jax.device_put(a, fsh)

    # 18 sharded coefficient constants: (ca, cb, cp, k1, k2, sig) x (x, y, z)
    coef_arrays = [padc(getattr(dc, n)[c])
                   for c in ("x", "y", "z")
                   for n in ("ca", "cb", "cp", "k1", "k2", "sig")]

    prof_np, mask_np = _source_pattern(p, (Jp, Ip), dtype)
    src_sh = NamedSharding(mesh, P("y", "x"))
    prof = jax.device_put(jnp.asarray(prof_np), src_sh)
    msrc = jax.device_put(jnp.asarray(mask_np), src_sh)

    shift_up, shift_down, gindex = _grid_ops(mesh, lsz)

    def local_step(amp, ex, ey, ez, hx, hy, hz, px, py, pz,
                   prof_l, msrc_l, *cf):
        if accumulate_power:
            acc = cf[-1]
            cf = cf[:-1]
        cx6, cy6, cz6 = cf[:6], cf[6:12], cf[12:18]
        shp = ex.shape
        gz = gindex(shp, 0)
        gy = gindex(shp, 1)
        gx = gindex(shp, 2)

        def inject(ex, ez, hx, hz):
            m = (gz == 0) & msrc_l[None, :, :]
            drive = (amp * prof_l[None, :, :]).astype(dtype)
            ez = jnp.where(m, drive, ez)
            ex = jnp.where(m, dtype.type(0), ex)
            hz = jnp.where(m, dtype.type(0), hz)
            hx = jnp.where(m, (-inv_z_te) * drive, hx)
            return ex, ez, hx, hz

        ex, ez, hx, hz = inject(ex, ez, hx, hz)

        # --- vacuum H half-step (identical to make_sharded_step's) ---
        ey_pz = shift_up(ey, 0)
        ey_px = shift_up(ey, 2)
        ez_py = shift_up(ez, 1)
        ez_px = shift_up(ez, 2)
        ex_pz = shift_up(ex, 0)
        ex_py = shift_up(ex, 1)
        m_hx = (gz < K) & (gy < J) & (gx < I + 1)
        m_hy = (gz < K) & (gy < J + 1) & (gx < I)
        m_hz = (gz < K + 1) & (gy < J) & (gx < I)
        hx = jnp.where(m_hx, hx + f_h * ((ey_pz - ey) - (ez_py - ez)), hx)
        hy = jnp.where(m_hy, hy + f_h * ((ez_px - ez) - (ex_pz - ex)), hy)
        hz = jnp.where(m_hz, hz + f_h * ((ex_py - ex) - (ey_px - ey)), hz)

        ex, ez, hx, hz = inject(ex, ez, hx, hz)

        # --- ADE E half-step: E' = ca E + cb curlH + cp P, then
        #     P' = k1 P + k2 (E' + E)  (ops/dispersive.update_e_ade) ---
        hz_my = shift_down(hz, 1)
        hy_mz = shift_down(hy, 0)
        hx_mz = shift_down(hx, 0)
        hz_mx = shift_down(hz, 2)
        hy_mx = shift_down(hy, 2)
        hx_my = shift_down(hx, 1)
        m_ex = (gz >= 1) & (gz < K) & (gy >= 1) & (gy < J) & (gx < I)
        m_ey = (gz >= 1) & (gz < K) & (gy < J) & (gx >= 1) & (gx < I)
        m_ez = (gz < K) & (gy >= 1) & (gy < J) & (gx >= 1) & (gx < I)
        curl_x = (hz - hz_my) - (hy - hy_mz)
        curl_y = (hx - hx_mz) - (hz - hz_mx)
        curl_z = (hy - hy_mx) - (hx - hx_my)

        works = []

        def advance(m, e_old, p_old, curl, c6):
            ca, cb, cp_, k1, k2, sig = c6
            en = (ca * e_old + cb * curl + cp_ * p_old).astype(dtype)
            pn = (k1 * p_old + k2 * (en + e_old)).astype(dtype)
            if accumulate_power:
                e_mid = 0.5 * (en + e_old)
                w = e_mid * ((pn - p_old) / dt_step + sig * e_mid)
                works.append(jnp.where(m, w, jnp.zeros_like(w)))
            return jnp.where(m, en, e_old), jnp.where(m, pn, p_old)

        ex, px = advance(m_ex, ex, px, curl_x, cx6)
        ey, py = advance(m_ey, ey, py, curl_y, cy6)
        ez, pz = advance(m_ez, ez, pz, curl_z, cz6)

        out = [ex, ey, ez, hx, hy, hz, px, py, pz]
        if accumulate_power:
            # cell-centered Debye work, the exact slice association of
            # ops/dispersive.work_cell_means (wx: +k, +j; wy: +i, +k;
            # wz: +j, +i) — shift_up planes are the masked-zero rows the
            # single-chip crop never reads
            wx, wy, wz = works
            mx = 0.25 * (wx + shift_up(wx, 0) + shift_up(wx, 1)
                         + shift_up(shift_up(wx, 0), 1))
            my = 0.25 * (wy + shift_up(wy, 2) + shift_up(wy, 0)
                         + shift_up(shift_up(wy, 0), 2))
            mz = 0.25 * (wz + shift_up(wz, 1) + shift_up(wz, 2)
                         + shift_up(shift_up(wz, 1), 2))
            inc = mx + my + mz
            out.append(acc + (inc * dt_step).astype(acc.dtype))
        return tuple(out)

    fspec = P(*AXES)
    n_extra = 18 + (1 if accumulate_power else 0)
    in_specs = (P(),) + (fspec,) * 9 + (P("y", "x"), P("y", "x")) \
        + (fspec,) * n_extra
    n_out = 9 + (1 if accumulate_power else 0)
    smap = jax.shard_map(
        local_step, mesh=mesh, in_specs=in_specs, out_specs=(fspec,) * n_out
    )

    def sharded_step(amp, s: FieldState, P3, *extra):
        args = [amp, s.ex, s.ey, s.ez, s.hx, s.hy, s.hz, *P3, prof, msrc,
                *coef_arrays]
        if accumulate_power:
            args.append(extra[0])
        outs = smap(*args)
        res = (FieldState(*outs[:6]), tuple(outs[6:9]))
        if accumulate_power:
            return res + (outs[9],)
        return res

    return sharded_step


def make_sharded_dispersive_chunk_runner(p: Params, mesh: Mesh, dm,
                                         accumulate_power: bool = False,
                                         dft=None, probes=None):
    """``run((state, P), xs, power, dft_acc) -> ((state, P), power,
    dft_acc, probe_ys)`` — the sharded analogue of
    :func:`fdtd_tpu.ops.dispersive.make_dispersive_chunk_runner` with the
    same monitored-chunk contract, so the runner wires both identically.
    ``power``/``dft_acc`` may be None when that monitor is off."""
    from ..monitors import apply_monitors, split_monitor_inputs

    step = make_sharded_dispersive_step(
        p, mesh, dm, accumulate_power=accumulate_power
    )
    if probes is not None:
        probes.validate(p)
    cells = probes.cells if probes is not None else None

    @jax.jit
    def run(carry, xs, power_acc, dft_acc):
        def body(c, x):
            (s, P3), acc, dacc = c
            (_t, amp), weights = split_monitor_inputs(x, dft)
            if accumulate_power:
                s, P3, acc = step(amp, s, P3, acc)
            else:
                s, P3 = step(amp, s, P3)
            dacc, ys = apply_monitors(p, s, weights, dft, cells, dacc)
            return ((s, P3), acc, dacc), ys

        ((s, P3), acc, dacc), ys = jax.lax.scan(
            body, (carry, power_acc, dft_acc), xs
        )
        return (s, P3), acc, dacc, ys

    return run


def extract_psi12(p: Params, cfg, psi12):
    """Sharded full-shape psi12 -> the canonical slab-restricted
    :class:`fdtd_tpu.ops.cpml.PsiState` (the checkpoint format).

    The sharded recursion keeps psi identically zero outside the slabs
    ((b, c) = (1, 0) there), and inside them it computes the very same
    values as the single-chip path, so cropping the slab rows is exact.
    psi values at slab rows *outside* a component's update region never
    feed a correction (the update masks exclude them) and are dropped.
    """
    from ..ops.cpml import PsiState, _TERMS, _slab_slices, _update_regions

    regions = _update_regions(p)
    out = {}
    for (name, target, _sign, axis, _src, _e), full in zip(_TERMS, psi12):
        lo_sl, hi_sl = _slab_slices(regions[target], axis, cfg.cells)
        out[name] = jnp.concatenate([full[lo_sl], full[hi_sl]], axis=axis)
    return PsiState(**out)


def embed_psi12(p: Params, cfg, psi, mesh: Mesh):
    """Canonical slab-restricted PsiState -> sharded full-shape psi12
    (the resume inverse of :func:`extract_psi12`).

    Slab rows outside the component's update region restart at zero —
    they are correction-inert (masked out), so a resumed run stays
    bit-equal to an uninterrupted one.
    """
    from ..ops.cpml import _TERMS, _slab_slices, _update_regions

    Kp, Jp, Ip = padded_divisible_shape(p, mesh)
    fsh = field_sharding(mesh)
    regions = _update_regions(p)
    n = cfg.cells
    out = []
    for name, target, _sign, axis, _src, _e in _TERMS:
        lo_sl, hi_sl = _slab_slices(regions[target], axis, n)
        a = jnp.asarray(getattr(psi, name))
        lo = lax.slice_in_dim(a, 0, n, axis=axis)
        hi = lax.slice_in_dim(a, n, 2 * n, axis=axis)
        full = (
            jnp.zeros((Kp, Jp, Ip), a.dtype)
            .at[lo_sl].set(lo)
            .at[hi_sl].set(hi)
        )
        out.append(jax.device_put(full, fsh))
    return tuple(out)


def dryrun(n_devices: int, devices=None) -> None:
    """One full sharded step on tiny shapes over an n_devices mesh.

    ``devices``: explicit device list (``__graft_entry__`` passes the
    virtual CPU devices of its hermetic child process)."""
    from ..params import Params as _P, SourceConfig
    from ..state import zeros
    from .mesh import make_mesh, pad_state_for_mesh

    mesh = make_mesh(n_devices, devices=devices)
    n = 16
    dx = 0.001
    p = _P(
        length=n * dx,
        width=n * dx,
        height=n * dx,
        spatial_step=dx,
        time_step=1e-12,
        simulation_time=4e-12,
        sampling_rate=10**9,
        mode=Mode.COMPUTATION,
        dtype="float32",
    )
    state = pad_state_for_mesh(p, zeros(p), mesh)
    run = make_sharded_monitored_chunk_runner(p, mesh)
    amps = jnp.asarray(np.array([0.0, 0.5, 1.0], dtype=np.float32))
    xs = (jnp.zeros_like(amps), amps)  # (t, amp); t only feeds monitors
    out, _, _, _ = run(state, xs, None, None)
    jax.block_until_ready(out.ex)

    # CPML x sharding (r3): psi12 rides the scan carry
    from ..ops.cpml import PMLConfig

    run_pml = make_sharded_monitored_chunk_runner(p, mesh,
                                                  pml=PMLConfig(cells=4))
    (outp, _psi), _, _, _ = run_pml(
        (pad_state_for_mesh(p, zeros(p), mesh), run_pml.zero_psi()), xs,
        None, None,
    )
    jax.block_until_ready(outp.ex)

    # CPML x sharding x SAR (r3): sharded accumulator + psi12 in the
    # carry; the canonical-psi round trip covers checkpoint interop
    from ..state import water_block
    from ..step import zero_power_acc
    from .mesh import padded_divisible_shape as _pds

    mats = water_block(p, lo=(0.3,) * 3, hi=(0.7,) * 3)
    run_ps = make_sharded_monitored_chunk_runner(
        p, mesh, mats, pml=PMLConfig(cells=4), accumulate_power=True)
    Kp_, Jp_, Ip_ = _pds(p, mesh)
    K_, J_, I_ = p.maxk, p.maxj, p.maxi
    acc0 = jax.device_put(
        jnp.pad(zero_power_acc(p),
                ((0, Kp_ - K_), (0, Jp_ - J_), (0, Ip_ - I_))),
        field_sharding(mesh),
    )
    (outs, psi12), acc, _, _ = run_ps(
        (pad_state_for_mesh(p, zeros(p), mesh), run_ps.zero_psi()), xs, acc0,
        None,
    )
    psi_rt = embed_psi12(p, PMLConfig(cells=4),
                         extract_psi12(p, PMLConfig(cells=4), psi12), mesh)
    jax.block_until_ready((outs.ex, acc, psi_rt[0]))
    # a cross-shard reduction exercises the collective path end-to-end
    total = jax.jit(lambda s: sum(jnp.sum(jnp.square(a.astype(jnp.float32))) for a in (s.ex, s.ey, s.ez, s.hx, s.hy, s.hz)))(out)
    assert bool(jnp.isfinite(total)), total

    # monitored sharded scan: --dft/--probe under --shard, through the
    # real run_simulation wiring
    import tempfile

    from ..dft import DftConfig
    from ..monitors import ProbeSet
    from ..runner import run_simulation

    with tempfile.TemporaryDirectory() as td:
        res = run_simulation(
            p, out_dir=td, write_snapshots=False,
            shard=str(n_devices), dft=DftConfig((p.source.frequency,)),
            probes=ProbeSet(((n // 2, n // 2, n // 2),)),
            log=lambda s: None,
        )
    assert res.dft is not None
    assert res.probes.values.shape == (res.iterations, 1, 6)

    # the --dft --pml --shard triple: psi12 and the monitors share the carry
    from ..ops.cpml import PMLConfig as _PC

    with tempfile.TemporaryDirectory() as td:
        res_t = run_simulation(
            p, out_dir=td, write_snapshots=False, shard=str(n_devices),
            pml=_PC(cells=3), dft=DftConfig((p.source.frequency,)),
            log=lambda s: None,
        )
    assert bool(jnp.all(jnp.isfinite(jnp.asarray(res_t.dft.phasors))))

    # dispersive ADE x sharding (r4): P rides the shard_map scan carry,
    # the SAR accumulator collects the TRUE Debye work — through the real
    # run_simulation wiring (prep/restore, padded P, acc pad/crop)
    from ..ops.dispersive import water_debye_load

    dm = water_debye_load(p, lo=(0.25,) * 3, hi=(0.75,) * 3,
                          sigma_ion25=0.2)
    with tempfile.TemporaryDirectory() as td:
        res_d = run_simulation(
            p, out_dir=td, write_snapshots=False, shard=str(n_devices),
            materials=dm, accumulate_power=True, log=lambda s: None,
        )
    assert res_d.power_j is not None
    assert bool(jnp.isfinite(jnp.sum(res_d.state.ez)))
