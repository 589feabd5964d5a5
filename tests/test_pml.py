"""CPML absorbing boundaries (ops/cpml.py — open-boundary extension).

The reference cavity is closed PEC (main.c:469-500 implicit PEC bounds),
so there is no reference behavior to match; these tests pin the physics
instead: (1) the correction is exactly inert until a wave reaches the
slabs, (2) an outgoing pulse is absorbed instead of reflected (energy
drops by orders of magnitude vs the energy-conserving PEC run), and
(3) the recursion is long-run stable.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fdtd_tpu.params import Mode, Params, time_values
from fdtd_tpu.state import zeros
from fdtd_tpu.step import make_chunk_runner, scan_inputs
from fdtd_tpu import diagnostics
from fdtd_tpu.ops.cpml import PMLConfig, init_psi, make_pml_chunk_runner


def _box_params(n, steps, dtype="float32"):
    return Params(
        length=n * 1e-3,
        width=n * 1e-3,
        height=n * 1e-3,
        spatial_step=1e-3,
        time_step=1e-12,
        simulation_time=steps * 1e-12,
        sampling_rate=10**9,
        mode=Mode.VALIDATION,  # no source; we seed a pulse by hand
        dtype=dtype,
    )


def _gaussian_pulse(p, radius=3.0, cutoff=None):
    """Zero fields + a Gaussian Ey ball at the cavity center.

    ``cutoff`` (cells): truncate to compact support — a raw Gaussian's
    tail is nonzero everywhere, including inside the PML slabs."""
    s = zeros(p)
    K1, J1, I1 = p.padded_shape
    k = np.arange(K1)[:, None, None]
    j = np.arange(J1)[None, :, None]
    i = np.arange(I1)[None, None, :]
    c = np.array([p.maxk / 2, p.maxj / 2, p.maxi / 2])
    r2 = (k - c[0]) ** 2 + (j - c[1]) ** 2 + (i - c[2]) ** 2
    blob = np.exp(-r2 / (2 * radius**2))
    if cutoff is not None:
        blob = np.where(r2 < cutoff**2, blob, 0.0)
    blob[:, p.maxj :, :] = 0.0  # respect Ey's physical j extent
    return dataclasses.replace(
        s, ey=jnp.asarray(blob, s.ey.dtype)
    )


def _solenoidal_pulse(p, radius=3.0, cutoff=None):
    """Divergence-free E pulse: E = discrete-curl(A_z g), so the Yee
    divergence the updates preserve is EXACTLY zero and the whole pulse
    is radiative.  (A single-component Gaussian ball keeps a ~1/3
    electrostatic remainder that no absorber can remove — Gauss's law.)
    """
    s = zeros(p)
    K1, J1, I1 = p.padded_shape
    k = np.arange(K1)[:, None, None]
    j = np.arange(J1)[None, :, None]
    i = np.arange(I1)[None, None, :]
    c = np.array([p.maxk / 2, p.maxj / 2, p.maxi / 2])
    r2 = (k - c[0]) ** 2 + (j - c[1]) ** 2 + (i - c[2]) ** 2
    g = np.exp(-r2 / (2 * radius**2))
    if cutoff is not None:
        g = np.where(r2 < cutoff**2, g, 0.0)
    ex = np.zeros((K1, J1, I1))
    ey = np.zeros((K1, J1, I1))
    # BACKWARD differences: the Yee divergence the updates preserve is
    # D_i^- ex + D_j^- ey (+ D_k^- ez), and D_i^- D_j^- commutes with
    # D_j^- D_i^- exactly — mixed forward/backward stencils leave a ~2%
    # static (non-radiative) remainder no absorber can remove
    ex[:, 1:, :] = g[:, 1:, :] - g[:, :-1, :]      # +D_j^- g
    ey[:, :, 1:] = -(g[:, :, 1:] - g[:, :, :-1])   # -D_i^- g
    ey[:, p.maxj :, :] = 0.0
    return dataclasses.replace(
        s,
        ex=jnp.asarray(ex, s.ex.dtype),
        ey=jnp.asarray(ey, s.ey.dtype),
    )


def _total_energy(p, s):
    return float(diagnostics.e_energy(p, s)) + float(diagnostics.h_energy(p, s))


def test_pml_inert_until_wave_arrives():
    """With the pulse confined to the interior, psi stays identically
    zero and the PML run is BIT-EQUAL to the plain xla run (b = 1, c = 0
    outside the slabs — the correction adds exact zeros)."""
    p = _box_params(40, 6, dtype="float64")
    cfg = PMLConfig(cells=8)
    # compact support (radius 5) + 6 steps of 1-cell/step light cone
    # stays strictly inside the interior (slabs start 12 cells out)
    s0 = _gaussian_pulse(p, radius=1.5, cutoff=5.0)
    xs = scan_inputs(p, time_values(p)[:6])

    run_ref = make_chunk_runner(p)
    want, _ = run_ref(s0, xs, None)

    run_pml = make_pml_chunk_runner(p, cfg)
    (got, psi), _ = run_pml((s0, init_psi(p, cfg)), xs, None)

    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, c)), np.asarray(getattr(want, c)),
            err_msg=c,
        )
    for name in ("hx_z", "ex_y", "ez_y"):
        assert float(jnp.abs(getattr(psi, name)).max()) == 0.0, name


def test_pml_absorbs_outgoing_pulse():
    """After ~4 cavity transit times, the PEC cavity still holds the
    pulse energy while the CPML walls have absorbed it."""
    n, steps = 32, 400
    p = _box_params(n, steps)
    cfg = PMLConfig(cells=8)
    s0 = _solenoidal_pulse(p, radius=3.0)
    e0 = _total_energy(p, s0)
    xs = scan_inputs(p, time_values(p)[:steps])

    run_ref = make_chunk_runner(p)
    pec, _ = run_ref(s0, xs, None)
    e_pec = _total_energy(p, pec)

    run_pml = make_pml_chunk_runner(p, cfg)
    (absorbed, _psi), _ = run_pml((s0, init_psi(p, cfg)), xs, None)
    e_pml = _total_energy(p, absorbed)

    # leapfrog PEC conserves the pulse energy (to discrete-energy slosh)
    assert e_pec > 0.2 * e0
    # CPML absorbs it: orders of magnitude below both the PEC run and
    # the initial energy (measured 2.0e-4 of e0 for 8-cell slabs)
    assert e_pml < 1e-3 * e_pec, (e_pml, e_pec, e0)
    assert e_pml < 1e-3 * e0


def test_pml_long_run_stable():
    """The CPML recursion must not blow up at late times (a classic
    failure mode of mis-signed psi updates)."""
    n, steps = 24, 1500
    p = _box_params(n, steps)
    cfg = PMLConfig(cells=6)
    s0 = _solenoidal_pulse(p, radius=2.5)
    e0 = _total_energy(p, s0)
    xs = scan_inputs(p, time_values(p)[:steps])
    run_pml = make_pml_chunk_runner(p, cfg)
    (s1, psi), _ = run_pml((s0, init_psi(p, cfg)), xs, None)
    e1 = _total_energy(p, s1)
    assert np.isfinite(e1)
    # measured 3.0e-3 of e0 (grazing incidence on the small box); the
    # bound catches blowup, not absorber quality
    assert e1 < 3e-2 * e0, (e1, e0)


def test_poynting_flux_energy_balance():
    """The time-integrated net outward Poynting flux through an interior
    box equals the energy the pulse radiates out of it: with CPML walls
    absorbing everything, integral(flux dt) ~ e0 to diagnostic accuracy
    (cell-centered S + the leapfrog half-step offset)."""
    from fdtd_tpu.ops.cpml import make_pml_step
    from fdtd_tpu.state import update_coefs

    n, steps = 32, 400
    p = _box_params(n, steps)
    cfg = PMLConfig(cells=8)
    s0 = _solenoidal_pulse(p, radius=3.0)
    e0 = _total_energy(p, s0)
    xs = scan_inputs(p, time_values(p)[:steps])
    step = make_pml_step(p, cfg, update_coefs(p, None))
    dt = p.time_step

    import functools

    @functools.partial(jax.jit)
    def run(carry, xs):
        def body(c, x):
            (s, psi), acc = c
            s, psi = step((s, psi), x)
            acc = acc + diagnostics.poynting_flux(p, s, margin=10) * dt
            return ((s, psi), acc), None

        (c, acc), _ = jax.lax.scan(body, (carry, jnp.zeros((), jnp.float32)), xs)
        return c, acc

    (s1, _), radiated = run((s0, init_psi(p, cfg)), xs)
    e1 = _total_energy(p, s1)
    radiated = float(radiated)
    assert e1 < 1e-3 * e0  # everything left the box and was absorbed
    # measured ratio 1.020 (cell-centered S + leapfrog half-step offset)
    np.testing.assert_allclose(radiated, e0 - e1, rtol=0.05)

    with pytest.raises(ValueError, match="margin"):
        diagnostics.poynting_flux(p, s0, margin=16)


def test_pml_diag_log_margin_clamped(tmp_path):
    """A valid PML config whose flux box margin (cells+1) would not fit
    must still run with --diag-log: the runner clamps the margin (22^3
    with 10-cell slabs used to crash at the first sample)."""
    from fdtd_tpu.runner import run_simulation

    p = dataclasses.replace(_box_params(22, 10), mode=Mode.COMPUTATION,
                            sampling_rate=5)
    r = run_simulation(p, out_dir=str(tmp_path / "o"), pml=PMLConfig(cells=10),
                       write_snapshots=False,
                       diagnostics_log=str(tmp_path / "d.jsonl"),
                       log=lambda s: None)
    assert r.iterations >= 10
    import json as _json

    with open(tmp_path / "d.jsonl") as f:
        recs = [_json.loads(line) for line in f]
    assert recs and all("radiated_W" in rec for rec in recs)


def test_gaussian_source_envelope():
    """The pulsed drive (extension; the reference is CW-only) is the CW
    carrier times a Gaussian — and the CW path is bit-unchanged."""
    from fdtd_tpu.params import SourceConfig
    from fdtd_tpu.source import drive_values, make_source_plan

    p = dataclasses.replace(
        _box_params(16, 10), mode=Mode.COMPUTATION,
        source=SourceConfig(envelope="gaussian", pulse_width=5e-11),
    )
    plan = make_source_plan(p)
    assert plan.pulse_width == 5e-11 and plan.pulse_delay == 1.5e-10
    t = np.linspace(0.0, 4e-10, 37)
    got = drive_values(plan, t)
    want = np.sin(2 * np.pi * plan.frequency * t) * np.exp(
        -((t - 1.5e-10) ** 2) / (2 * 5e-11**2)
    )
    np.testing.assert_array_equal(got, want)

    p_cw = dataclasses.replace(p, source=SourceConfig())
    plan_cw = make_source_plan(p_cw)
    np.testing.assert_array_equal(
        drive_values(plan_cw, t), np.sin(2 * np.pi * plan_cw.frequency * t)
    )

    with pytest.raises(ValueError, match="envelope"):
        make_source_plan(dataclasses.replace(
            p, source=SourceConfig(envelope="square")))
    with pytest.raises(ValueError, match="width"):
        make_source_plan(dataclasses.replace(
            p, source=SourceConfig(envelope="gaussian", pulse_width=-1.0)))


def test_gaussian_burst_rings_down_through_pml():
    """A pulsed port drive + CPML: after the burst passes, the cavity
    energy decays orders of magnitude below its mid-burst level (a CW
    drive would keep pumping; a PEC box would keep ringing)."""
    from fdtd_tpu.params import SourceConfig
    from fdtd_tpu.state import update_coefs

    n = 16
    width = 8e-11
    p = dataclasses.replace(
        _box_params(n, 1200), mode=Mode.COMPUTATION,
        source=SourceConfig(envelope="gaussian", pulse_width=width),
    )
    cfg = PMLConfig(cells=4)
    run_pml = make_pml_chunk_runner(p, cfg)
    ts = time_values(p)
    mid = 300  # ~ the envelope center (3 widths = 2.4e-10 s = step 240)
    xs_a = scan_inputs(p, ts[:mid])
    xs_b = scan_inputs(p, ts[mid:1200])
    carry, _ = run_pml((zeros(p), init_psi(p, cfg)), xs_a, None)
    e_mid = _total_energy(p, carry[0])
    carry, _ = run_pml(carry, xs_b, None)
    e_end = _total_energy(p, carry[0])
    assert e_mid > 0
    assert e_end < 2e-2 * e_mid, (e_end, e_mid)


def test_pml_runner_and_materials(tiny_params, tmp_path):
    """run_simulation(pml=...) end-to-end: snapshots written, composes
    with lossy materials + SAR, and the unsupported combos error
    cleanly."""
    from fdtd_tpu.runner import run_simulation
    from fdtd_tpu.state import water_block

    p = dataclasses.replace(tiny_params, dtype="float32",
                            mode=Mode.COMPUTATION, sampling_rate=10)
    cfg = PMLConfig(cells=3)
    r = run_simulation(p, out_dir=str(tmp_path / "a"), pml=cfg,
                       log=lambda s: None)
    assert r.iterations >= 20
    assert (tmp_path / "a" / "result0020.vtr").exists()

    mats = water_block(p, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7))
    r2 = run_simulation(p, out_dir=str(tmp_path / "b"), pml=cfg,
                        materials=mats, accumulate_power=True,
                        write_snapshots=False,
                        diagnostics_log=str(tmp_path / "d.jsonl"),
                        log=lambda s: None)
    assert r2.power_j is not None
    assert float(np.asarray(r2.power_j).max()) >= 0
    import json as _json

    with open(tmp_path / "d.jsonl") as f:
        recs = [_json.loads(line) for line in f]
    assert recs and all("radiated_W" in r for r in recs)

    with pytest.raises(ValueError, match="PML"):
        run_simulation(p, out_dir=str(tmp_path / "x"),
                       pml=PMLConfig(cells=6), log=lambda s: None)


@pytest.mark.parametrize("mesh_shape", [(4, 1, 1), (2, 2, 2)])
def test_pml_sharded_matches_single_device(mesh_shape):
    """CPML x spatial sharding (make_sharded_step(pml=)): the psi
    recursion runs per shard on the halo-exchanged differences with
    rank-offset profile slices == the single-chip cpml chunk runner."""
    from fdtd_tpu.parallel.mesh import make_mesh, pad_state_for_mesh, unpad_state
    from fdtd_tpu.parallel.sharded_step import make_sharded_monitored_chunk_runner

    n, steps = 24, 60
    p = _box_params(n, steps, dtype="float64")
    cfg = PMLConfig(cells=6)
    s0 = _solenoidal_pulse(p, radius=2.5)
    xs = scan_inputs(p, time_values(p)[:steps])

    run_ref = make_pml_chunk_runner(p, cfg)
    (want, _), _ = run_ref((s0, init_psi(p, cfg)), xs, None)

    ndev = int(np.prod(mesh_shape))
    mesh = make_mesh(ndev, mesh_shape, devices=jax.devices("cpu"))
    run_sh = make_sharded_monitored_chunk_runner(p, mesh, pml=cfg)
    st = pad_state_for_mesh(p, s0, mesh)
    (st, _psi), _, _, _ = run_sh((st, run_sh.zero_psi()), xs, None, None)
    got = unpad_state(p, st)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_allclose(
            np.asarray(getattr(got, c)), np.asarray(getattr(want, c)),
            atol=1e-20, rtol=1e-12, err_msg=c,
        )
    # absorption engaged (the pulse reached the slabs well within 60 steps)
    assert _total_energy(p, got) < 0.9 * _total_energy(p, s0)


def test_pml_sharded_runner_end_to_end(tiny_params, tmp_path):
    """run_simulation(pml=..., shard=...): end-to-end == the unsharded
    PML run through the full snapshot pipeline."""
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays
    from fdtd_tpu.runner import run_simulation

    p = dataclasses.replace(tiny_params, dtype="float32",
                            mode=Mode.COMPUTATION, sampling_rate=10)
    cfg = PMLConfig(cells=3)
    run_simulation(p, out_dir=str(tmp_path / "one"), pml=cfg,
                   log=lambda s: None)
    run_simulation(p, out_dir=str(tmp_path / "sh"), pml=cfg, shard="4",
                   log=lambda s: None)
    a = read_vtr_cell_arrays(str(tmp_path / "one" / "result0020.vtr"))
    b = read_vtr_cell_arrays(str(tmp_path / "sh" / "result0020.vtr"))
    for k in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_allclose(a[k], b[k], atol=1e-7, rtol=1e-5,
                                   err_msg=k)
    # --sar still needs lossy materials under --pml --shard (the
    # SAR/checkpoint compositions themselves are covered by
    # test_pml_shard_sar_matches_single_chip / test_pml_shard_checkpoint_resume)
    with pytest.raises(ValueError, match="materials"):
        run_simulation(p, out_dir=str(tmp_path / "x"), pml=cfg, shard="4",
                       accumulate_power=True, log=lambda s: None)


def test_pml_het_mu_lossy_sharded_matches_single_device():
    """CPML x heterogeneous-mu + lossy media: the correction scales by
    the per-component hf factors / cb slabs on both the single-chip and
    sharded paths; pinned by (a) bit-inertness while the pulse is
    interior and (b) sharded == single-chip over a (2,2,1) mesh."""
    from fdtd_tpu.parallel.mesh import make_mesh, pad_state_for_mesh, unpad_state
    from fdtd_tpu.parallel.sharded_step import make_sharded_monitored_chunk_runner
    from fdtd_tpu.state import Materials

    n = 32
    p = _box_params(n, 50, dtype="float64")
    cfg = PMLConfig(cells=6)
    K, J, I = p.maxk, p.maxj, p.maxi
    er = np.ones((K, J, I))
    sg = np.zeros((K, J, I))
    mu = np.ones((K, J, I))
    c0, c1 = n // 2 - 3, n // 2 + 3  # interior blocks, clear of the slabs
    er[c0:c1, c0:c1, c0:c1] = 8.0
    sg[c0:c1, c0:c1, c0:c1] = 0.4
    mu[c0:c1, c0:c1, c0:c1] = 3.0
    mats = Materials(eps_r=er, sigma=sg, mu_r=mu)

    s0 = _gaussian_pulse(p, radius=1.5, cutoff=4.0)

    # (a) inert until the wave reaches the slabs: support |r| < 4 around
    # center 16 ends at cell 19, the slab starts at 26, and the discrete
    # light cone grows <= 1 cell/step -> 6 steps stay strictly interior
    xs6 = scan_inputs(p, time_values(p)[:6])
    want6, _ = make_chunk_runner(p, mats)(s0, xs6, None)
    (got6, _), _ = make_pml_chunk_runner(p, cfg, mats)((s0, init_psi(p, cfg)), xs6, None)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(got6, c)), np.asarray(getattr(want6, c)),
            err_msg=c,
        )

    # (b) sharded == single-chip after the wave engages the absorber
    steps = 50
    xs = scan_inputs(p, time_values(p)[:steps])
    (want, _), _ = make_pml_chunk_runner(p, cfg, mats)((s0, init_psi(p, cfg)), xs, None)
    mesh = make_mesh(4, (2, 2, 1), devices=jax.devices("cpu"))
    run_sh = make_sharded_monitored_chunk_runner(p, mesh, mats, pml=cfg)
    st = pad_state_for_mesh(p, s0, mesh)
    (st, _psi), _, _, _ = run_sh((st, run_sh.zero_psi()), xs, None, None)
    got = unpad_state(p, st)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        # the material coefficient multiplies group differently between
        # the masked sharded path and the slice-based single-chip one
        # (fp64 FMA reassociation; measured max rel 4.3e-12)
        np.testing.assert_allclose(
            np.asarray(getattr(got, c)), np.asarray(getattr(want, c)),
            atol=1e-18, rtol=1e-10, err_msg=c,
        )


def test_pml_checkpoint_resume_bit_exact(tiny_params, tmp_path):
    """The psi memory variables ride the checkpoint (aux arrays), so a
    resumed PML run is BIT-EQUAL to the uninterrupted one — resuming
    with psi = 0 would give the slab fields a spurious transient."""
    from fdtd_tpu.io.checkpoint import load_aux, latest_checkpoint
    from fdtd_tpu.runner import run_simulation

    p = dataclasses.replace(tiny_params, dtype="float32",
                            mode=Mode.COMPUTATION, sampling_rate=10)
    cfg = PMLConfig(cells=3)
    ra = run_simulation(p, out_dir=str(tmp_path / "full"), pml=cfg,
                        write_snapshots=False, log=lambda s: None)

    # interrupted run: checkpoint at step 10, then a fresh resume
    p_half = dataclasses.replace(p, simulation_time=1e-11)
    run_simulation(p_half, out_dir=str(tmp_path / "part"), pml=cfg,
                   checkpoint_every=10, write_snapshots=False,
                   log=lambda s: None)
    ck = latest_checkpoint(str(tmp_path / "part"))
    assert ck is not None
    aux = load_aux(ck)
    assert any(k.startswith("psi_") for k in aux)
    # psi has engaged by step 10 on this tiny (all-slab) grid
    assert max(float(np.abs(v).max()) for v in aux.values()) > 0

    rb = run_simulation(p, out_dir=str(tmp_path / "part"), pml=cfg,
                        resume=True, checkpoint_every=10,
                        write_snapshots=False, log=lambda s: None)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(rb.state, c)), np.asarray(getattr(ra.state, c)),
            err_msg=c,
        )


def test_pml_shard_sar_matches_single_chip():
    """--pml --shard --sar: the sharded SAR accumulator (cell-centered
    means from the same halo shifts the curls use) matches the
    single-chip xla PML+SAR accumulation, and the extracted canonical
    psi matches the slab-restricted single-chip PsiState — both to the
    lossy masked-vs-sliced fp64 reassociation tolerance."""
    from fdtd_tpu.parallel.mesh import (
        field_sharding,
        make_mesh,
        pad_state_for_mesh,
        padded_divisible_shape,
        unpad_state,
    )
    from fdtd_tpu.parallel.sharded_step import (
        extract_psi12,
        make_sharded_monitored_chunk_runner,
    )
    from fdtd_tpu.state import water_block
    from fdtd_tpu.step import zero_power_acc

    n, steps = 20, 30
    p = dataclasses.replace(_box_params(n, steps, dtype="float64"),
                            mode=Mode.COMPUTATION)
    cfg = PMLConfig(cells=4)
    xs = scan_inputs(p, time_values(p)[:steps])
    mats = water_block(p, lo=(0.35,) * 3, hi=(0.65,) * 3)

    run_x = make_pml_chunk_runner(p, cfg, mats, accumulate_power=True)
    (want, psi_w), pw_want = run_x(
        (zeros(p), init_psi(p, cfg)), xs, zero_power_acc(p)
    )

    K, J, I = p.maxk, p.maxj, p.maxi
    mesh = make_mesh(4, (4, 1, 1), devices=jax.devices("cpu"))
    run_sh = make_sharded_monitored_chunk_runner(p, mesh, mats, pml=cfg,
                                                 accumulate_power=True)
    Kp, Jp, Ip = padded_divisible_shape(p, mesh)
    acc0 = jax.device_put(
        jnp.pad(zero_power_acc(p), ((0, Kp - K), (0, Jp - J), (0, Ip - I))),
        field_sharding(mesh),
    )
    st0 = pad_state_for_mesh(p, zeros(p), mesh)
    (st, psi12), acc, _, _ = run_sh((st0, run_sh.zero_psi()), xs, acc0,
                                    None)
    got = unpad_state(p, st)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_allclose(
            np.asarray(getattr(got, c)), np.asarray(getattr(want, c)),
            atol=1e-18, rtol=1e-10, err_msg=c,
        )
    np.testing.assert_allclose(np.asarray(acc[:K, :J, :I]),
                               np.asarray(pw_want), atol=1e-30, rtol=1e-9)
    assert float(np.asarray(pw_want).max()) > 0
    psi_g = extract_psi12(p, cfg, psi12)
    for nm in type(psi_w).__dataclass_fields__:
        np.testing.assert_allclose(
            np.asarray(getattr(psi_g, nm)), np.asarray(getattr(psi_w, nm)),
            atol=1e-25, rtol=1e-9, err_msg=nm,
        )


def test_pml_shard_checkpoint_resume(tmp_path):
    """--pml --shard + checkpoint/resume: the sharded psi12 carry rides
    checkpoints in the canonical slab-restricted PsiState layout
    (extract_psi12/embed_psi12), so (a) a resumed sharded run is
    BIT-EQUAL to the uninterrupted sharded run, and (b) a single-chip
    PML checkpoint resumes under --shard (interoperable format)."""
    from fdtd_tpu.runner import run_simulation

    n = 20
    p = dataclasses.replace(_box_params(n, 30, dtype="float32"),
                            mode=Mode.COMPUTATION, sampling_rate=10)
    cfg = PMLConfig(cells=4)
    rfull = run_simulation(p, out_dir=str(tmp_path / "full"), pml=cfg,
                           shard="4", write_snapshots=False,
                           log=lambda s: None)
    p_half = dataclasses.replace(p, simulation_time=15e-12)
    run_simulation(p_half, out_dir=str(tmp_path / "part"), pml=cfg,
                   shard="4", checkpoint_every=10, write_snapshots=False,
                   log=lambda s: None)
    rres = run_simulation(p, out_dir=str(tmp_path / "part"), pml=cfg,
                          shard="4", resume=True, checkpoint_every=10,
                          write_snapshots=False, log=lambda s: None)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(rres.state, c)),
            np.asarray(getattr(rfull.state, c)), err_msg=c,
        )

    # (b) cross-topology: single-chip xla checkpoint -> sharded resume
    run_simulation(p_half, out_dir=str(tmp_path / "part2"), pml=cfg,
                   backend="xla", checkpoint_every=10,
                   write_snapshots=False, log=lambda s: None)
    rx = run_simulation(p, out_dir=str(tmp_path / "part2"), pml=cfg,
                        shard="4", resume=True, checkpoint_every=10,
                        write_snapshots=False, log=lambda s: None)
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        # masked-vs-sliced fp32 reassociation across the topology switch
        np.testing.assert_allclose(
            np.asarray(getattr(rx.state, c)),
            np.asarray(getattr(rfull.state, c)),
            atol=5e-6, rtol=1e-4, err_msg=c,
        )


def test_pml_cli_flag(tiny_params, tmp_path, capsys):
    from fdtd_tpu.cli import main

    params = tmp_path / "p.txt"
    params.write_text("0.01\n0.01\n0.01\n0.001\n1e-12\n2e-11\n10\n0\n")
    rc = main([str(params), "--out", str(tmp_path / "o"), "--pml", "3",
               "--no-output"])
    assert rc == 0


def _rel_l2(got, want):
    num = sum(float(((np.asarray(g, np.float64) - np.asarray(w)) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((np.asarray(w) ** 2).sum()) for w in want)
    return (num / den) ** 0.5


def _pml_runs(case, dtypes=("float32", "float64"), **kw):
    """One CPML run per dtype of a 12^3 computation-mode scene."""
    from fdtd_tpu.runner import run_simulation
    from fdtd_tpu.state import ferrite_slab, water_block

    out = []
    for dtype in dtypes:
        p = dataclasses.replace(_box_params(12, 30, dtype),
                                mode=Mode.COMPUTATION)
        mats = None
        if case != "vacuum":
            mats = water_block(p, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7))
        if case == "het-mu":
            mats = ferrite_slab(p, base=mats)
        out.append(run_simulation(
            p, pml=PMLConfig(cells=3), materials=mats,
            accumulate_power=case == "lossy+sar", write_snapshots=False,
            log=lambda s: None, **kw))
    return out


_FIELDS6 = ("ex", "ey", "ez", "hx", "hy", "hz")


@pytest.mark.parametrize("case", ["vacuum", "lossy+sar", "het-mu"])
def test_pml_fp32_matches_fp64(case):
    """The CPML scan in fp32 stays within the north-star 1e-5 L2 of the
    same scan in fp64, for vacuum, a lossy load with SAR, and
    heterogeneous mu_r."""
    r32, r64 = _pml_runs(case)
    fields = lambda r: [getattr(r.state, c) for c in _FIELDS6]
    assert _rel_l2(fields(r32), fields(r64)) < 1e-5
    if case == "lossy+sar":
        assert float(np.asarray(r64.power_j).max()) > 0
        assert _rel_l2([r32.power_j], [r64.power_j]) < 1e-5


@pytest.mark.parametrize("sar", [False, True])
def test_pml_dft_fp32_matches_fp64(sar):
    """--pml --dft: the open-boundary phasors in fp32 against fp64."""
    from fdtd_tpu.dft import DftConfig

    r32, r64 = _pml_runs("lossy+sar" if sar else "vacuum",
                         dft=DftConfig((2.45e10,)))
    ph = lambda r: [r.dft.phasors.real, r.dft.phasors.imag]
    assert float(np.abs(r64.dft.phasors).max()) > 0
    assert _rel_l2(ph(r32), ph(r64)) < 1e-5


def test_pml_dft_checkpoint_resume_bit_exact(tmp_path):
    """--pml --dft with a checkpoint and a resume: psi and the running
    phasor sums ride the checkpoint, so the resumed run's fields and
    phasors equal the uninterrupted run's bit for bit."""
    from fdtd_tpu.dft import DftConfig
    from fdtd_tpu.runner import run_simulation

    p = dataclasses.replace(_box_params(12, 30), mode=Mode.COMPUTATION)
    cfg, dftc = PMLConfig(cells=3), DftConfig((2.45e10,))
    kw = dict(pml=cfg, dft=dftc, write_snapshots=False, log=lambda s: None)
    full = run_simulation(p, out_dir=str(tmp_path / "full"), **kw)
    p_half = dataclasses.replace(p, simulation_time=14.5e-12)
    run_simulation(p_half, out_dir=str(tmp_path / "part"),
                   checkpoint_every=15, **kw)
    res = run_simulation(p, out_dir=str(tmp_path / "part"), resume=True,
                         checkpoint_every=15, **kw)
    for c in _FIELDS6:
        np.testing.assert_array_equal(np.asarray(getattr(res.state, c)),
                                      np.asarray(getattr(full.state, c)))
    np.testing.assert_array_equal(res.dft.phasors, full.dft.phasors)
