"""ADE Debye dispersion (fdtd_tpu/ops/dispersive.py).

Pins: the P-recursion against the Debye ODE's exact discrete limits
(static fixed point is an algebraic identity; CW steady state matches
the complex susceptibility to O((w dt)^2)); exact reduction to the
non-dispersive lossy path at d_eps = 0; and the integration-level
physics — a cavity uniformly filled with a weak Debye medium rings
down with Q = 1/tan(delta) at the measured mode frequency.
"""

import numpy as np
import pytest

from fdtd_tpu.constants import EPSILON
from fdtd_tpu.monitors import ProbeSet
from fdtd_tpu.ops.dispersive import (
    DebyeMaterials,
    debye_coefs,
    water_debye_load,
)
from fdtd_tpu.params import Mode, Params
from fdtd_tpu.runner import run_simulation
from fdtd_tpu.state import Materials, block_mask, water_block


def _box(n, dt, steps, mode=Mode.COMPUTATION, dtype="float32"):
    return Params(
        length=n * 1e-3, width=n * 1e-3, height=n * 1e-3,
        spatial_step=1e-3, time_step=dt,
        simulation_time=(steps - 0.5) * dt, sampling_rate=10**9,
        mode=mode, dtype=dtype,
    )


def _uniform_debye(p, eps_inf=1.0, d_eps=0.2, tau=8e-12, sigma=0.0):
    shape = (p.maxk, p.maxj, p.maxi)
    return DebyeMaterials(
        base=Materials(eps_r=np.full(shape, eps_inf),
                       sigma=np.full(shape, sigma)),
        d_eps=np.full(shape, d_eps),
        tau=np.full(shape, tau),
    )


def test_ade_recursion_matches_debye_ode():
    """Scalar P-recursion: the static fixed point equals eps0*d_eps*E
    exactly (trapezoidal identity), and the CW steady state matches the
    complex susceptibility d_eps/(1 + i w tau) to O((w dt)^2)."""
    d_eps, tau = 5.0, 8.0e-12
    dt = tau / 64.0
    p = _box(6, dt, 4, dtype="float64")
    dm = _uniform_debye(p, d_eps=d_eps, tau=tau)
    dc = debye_coefs(p, dm, dtype=np.float64)
    k1 = float(dc.k1["y"][2, 2, 2])
    k2 = float(dc.k2["y"][2, 2, 2])
    # static: P* = 2 k2 E / (1 - k1) == eps0 d_eps E (identity)
    np.testing.assert_allclose(2 * k2 / (1 - k1), EPSILON * d_eps,
                               rtol=1e-12)
    # and the relaxation rate: k1 = (2tau-dt)/(2tau+dt) ~ exp(-dt/tau)
    np.testing.assert_allclose(k1, np.exp(-dt / tau), rtol=1e-4)

    # CW: P' = k1 P + k2 (E' + E) driven by E = cos(w t), w tau = 1
    w = 1.0 / tau
    n_per = int(round(2 * np.pi / (w * dt)))
    steps = 40 * n_per
    t = np.arange(steps) * dt
    E = np.cos(w * t)
    P = 0.0
    out = np.empty(steps)
    for i in range(1, steps):
        P = k1 * P + k2 * (E[i] + E[i - 1])
        out[i] = P
    # steady state over the last 8 whole periods: quadrature demodulation
    sl = slice(steps - 8 * n_per, steps)
    z = out[sl] * np.exp(-1j * w * t[sl])
    phasor = 2.0 * z.mean()
    want = EPSILON * d_eps / (1 + 1j * w * tau)
    np.testing.assert_allclose(abs(phasor), abs(want), rtol=3e-3)
    np.testing.assert_allclose(np.angle(phasor), np.angle(want),
                               atol=5e-2)  # includes the half-step skew


def test_deps_zero_reduces_to_lossy_path():
    """d_eps = 0: the ADE update is algebraically the standard lossy
    update, so a dispersive run with zero relaxation strength matches
    the plain lossy run on the same eps_inf/sigma maps."""
    p = _box(8, 1e-12, 20)
    plain = water_block(p)  # eps 78, sigma 1.7 in the block
    dm = DebyeMaterials(
        base=plain,
        d_eps=np.zeros((p.maxk, p.maxj, p.maxi)),
        tau=np.zeros((p.maxk, p.maxj, p.maxi)),
    )
    want = run_simulation(p, materials=plain, write_snapshots=False,
                          backend="xla", log=lambda s: None)
    got = run_simulation(p, materials=dm, write_snapshots=False,
                         backend="xla", log=lambda s: None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.state, c)),
            np.asarray(getattr(want.state, c)),
            rtol=2e-5, atol=1e-7,
        )


def test_debye_cavity_ring_down_q():
    """A cavity uniformly filled with a weak Debye medium: the TE101
    ring-down Q equals 1/tan(delta) of the medium at the measured mode
    frequency (uniform fill, PEC walls -> Q = eps'/eps'')."""
    from fdtd_tpu.analytic import mode_constants
    from fdtd_tpu.utils.spectrum import probe_mode_spectrum, ring_down_q

    n = 10
    base = _box(n, 1e-12, 4, mode=Mode.VALIDATION)
    f_vac, _ = mode_constants(base)
    eps_inf, d_eps = 1.0, 0.2
    tau = 1.0 / (2 * np.pi * 2.0e10)
    per_period = 40
    dt = 1.0 / (f_vac * per_period)
    p = _box(n, dt, 20 * per_period, mode=Mode.VALIDATION)
    dm = _uniform_debye(p, eps_inf=eps_inf, d_eps=d_eps, tau=tau)
    res = run_simulation(p, materials=dm, write_snapshots=False,
                         backend="xla", probes=ProbeSet(((5, 5, 5),)),
                         log=lambda s: None)
    ey = res.probes.series(0, "ey")
    t = res.probes.times
    # measured mode frequency (red-shifted by eps' > 1)
    _f, _a, peaks = probe_mode_spectrum(res, component="ey")
    f_meas = peaks[0][0]
    assert f_meas < f_vac  # the dielectric slows the mode
    q_meas, gamma, _ = ring_down_q(t, ey, frequency=f_meas)
    w = 2 * np.pi * f_meas
    wt = w * tau
    eps_p = eps_inf + d_eps / (1 + wt * wt)
    eps_pp = d_eps * wt / (1 + wt * wt)
    q_want = eps_p / eps_pp
    assert gamma > 0
    np.testing.assert_allclose(q_meas, q_want, rtol=0.25)


def test_dispersive_guards_and_cli(tmp_path):
    from fdtd_tpu.cli import main
    from fdtd_tpu.dft import DftConfig

    p = _box(8, 1e-12, 8)
    dm = water_debye_load(p)
    from fdtd_tpu.ops.cpml import PMLConfig

    # dispersive x PML composes since r5 (single-chip); sharded stays gated
    with pytest.raises(ValueError, match="no --shard"):
        run_simulation(p, materials=dm, pml=PMLConfig(cells=2), shard="2",
                       write_snapshots=False, log=lambda s: None)
    # monitors compose
    res = run_simulation(p, materials=dm, write_snapshots=False,
                         probes=ProbeSet(((4, 4, 4),)),
                         dft=DftConfig((p.source.frequency,)),
                         backend="xla", log=lambda s: None)
    assert res.probes.values.shape[0] == res.iterations
    assert np.isfinite(res.dft.phasors).all()

    params = tmp_path / "p.txt"
    params.write_text("0.01\n0.01\n0.01\n0.001\n1e-12\n2e-11\n1000000000\n1\n")
    out = tmp_path / "o"
    rc = main([str(params), "--water-block", "--dispersive",
               "--probe", "5,5,5", "--out", str(out)])
    assert rc == 0
    assert (out / "probes.csv").exists()
    assert main([str(params), "--dispersive"]) == 1  # needs --water-block
    assert main([str(params), "--water-block", "--dispersive",
                 "--coupled", "2", "--thermal", "5"]) == 1

    # the full dispersive heating chain: true Debye SAR -> thermal
    out2 = tmp_path / "o2"
    rc = main([str(params), "--water-block", "--dispersive", "--sar",
               "--thermal", "30", "--thermal-power", "700",
               "--out", str(out2)])
    assert rc == 0
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    sar = read_vtr_cell_arrays(str(out2 / "sar.vtr"))["power_j_m3"]
    T = read_vtr_cell_arrays(str(out2 / "temperature.vtr"))["temperature_c"]
    assert float(sar.max()) > 0.0
    assert float(T.max()) > 20.0


def test_water_debye_load_consistency():
    """The ADE load's static limit (eps_inf + d_eps) equals the
    quasi-static model's eps_s at the same temperature."""
    from fdtd_tpu.coupled import water_eps_static

    p = _box(10, 1e-12, 4)
    dm = water_debye_load(p, temperature=40.0, sigma_ion25=1.0)
    mask = block_mask(p)
    eps_static = dm.base.eps_r[mask] + dm.d_eps[mask]
    np.testing.assert_allclose(eps_static, float(water_eps_static(40.0)),
                               rtol=1e-12)
    # ionic sigma scaled to 40 C by the +2%/K coefficient
    np.testing.assert_allclose(dm.base.sigma[mask],
                               1.0 * (1 + 0.02 * 15), rtol=1e-12)
    np.testing.assert_allclose(dm.d_eps[~mask], 0.0)


def test_effective_sigma_matches_quasi_static_model():
    """sigma_eff(w) of the ADE load equals the quasi-static coupled
    model's Debye-loss sigma at the same frequency and temperature —
    the two descriptions agree at any single frequency by design."""
    from fdtd_tpu.coupled import water_debye
    from fdtd_tpu.ops.dispersive import effective_sigma

    p = _box(10, 1e-12, 4)
    f = 2.45e9
    dm = water_debye_load(p, temperature=30.0, sigma_ion25=0.5)
    mask = block_mask(p)
    sig = effective_sigma(dm, f)
    _, want = water_debye(30.0, frequency=f, sigma_ion25=0.5)
    np.testing.assert_allclose(sig[mask], float(want), rtol=1e-12)
    np.testing.assert_allclose(sig[~mask], 0.0)


def test_dispersive_dft_cli_writes_cw_power(tmp_path):
    from fdtd_tpu.cli import main
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    params = tmp_path / "p.txt"
    params.write_text("0.01\n0.01\n0.01\n0.001\n1e-12\n2e-11\n1000000000\n1\n")
    out = tmp_path / "o"
    rc = main([str(params), "--water-block", "--dispersive",
               "--dft", "2.45e10", "--out", str(out)])
    assert rc == 0
    a = read_vtr_cell_arrays(str(out / "dft_00.vtr"))
    assert "cw_power_w_m3" in a
    assert float(a["cw_power_w_m3"].min()) >= 0.0
    assert float(a["cw_power_w_m3"].max()) > 0.0


def test_dispersive_checkpoint_resume(tmp_path):
    """The polarization state rides checkpoints: full run == interrupted
    + resumed run, bit-for-bit (the P arrays are aux_pol_* in the
    checkpoint, like the CPML psi)."""
    import glob
    import os

    p = _box(8, 1e-12, 16)
    dm = water_debye_load(p)
    out_a = str(tmp_path / "a")
    out_b = str(tmp_path / "b")
    ra = run_simulation(p, materials=dm, out_dir=out_a,
                        write_snapshots=False, checkpoint_every=8,
                        backend="xla", log=lambda s: None)
    run_simulation(p, materials=dm, out_dir=out_b,
                   write_snapshots=False, checkpoint_every=8,
                   backend="xla", log=lambda s: None)
    for f in glob.glob(out_b + "/ckpt*.npz"):
        if int(os.path.basename(f)[4:-4]) > 8:
            os.remove(f)
    rb = run_simulation(p, materials=dm, out_dir=out_b,
                        write_snapshots=False, resume=True,
                        backend="xla", log=lambda s: None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ra.state, c)),
            np.asarray(getattr(rb.state, c)),
        )


@pytest.mark.parametrize("shard", ["2", "2x2"])
def test_dispersive_sharded_parity(shard):
    """--dispersive --shard (r4): the shard_map ADE scan with P in the
    carry matches the single-chip ADE scan element-for-element, and the
    sharded TRUE-Debye-work SAR accumulator matches the single-chip one."""
    p = _box(10, 1e-12, 24, dtype="float64")
    dm = water_debye_load(p, sigma_ion25=0.5)
    want = run_simulation(p, materials=dm, write_snapshots=False,
                          accumulate_power=True, backend="xla",
                          log=lambda s: None)
    got = run_simulation(p, materials=dm, write_snapshots=False,
                         accumulate_power=True, shard=shard,
                         log=lambda s: None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.state, c)),
            np.asarray(getattr(want.state, c)),
            rtol=0, atol=1e-14,
        )
    np.testing.assert_allclose(np.asarray(got.power_j),
                               np.asarray(want.power_j),
                               rtol=1e-12, atol=1e-30)


def test_dispersive_sharded_monitors_and_checkpoint(tmp_path):
    """Monitors (--dft/--probe) compose with --dispersive --shard, and a
    sharded dispersive checkpoint resumes bit-exactly AND interoperates
    with a single-chip resume (canonical pol_* layout either way)."""
    import glob
    import os

    from fdtd_tpu.dft import DftConfig

    p = _box(8, 1e-12, 16, dtype="float64")
    dm = water_debye_load(p)
    res = run_simulation(p, materials=dm, write_snapshots=False,
                         shard="2", probes=ProbeSet(((4, 4, 4),)),
                         dft=DftConfig((p.source.frequency,)),
                         log=lambda s: None)
    assert res.probes.values.shape == (res.iterations, 1, 6)
    assert np.isfinite(res.dft.phasors).all()
    # probe series equals the single-chip one
    res1 = run_simulation(p, materials=dm, write_snapshots=False,
                          probes=ProbeSet(((4, 4, 4),)), backend="xla",
                          log=lambda s: None)
    np.testing.assert_allclose(res.probes.values, res1.probes.values,
                               rtol=0, atol=1e-15)

    # checkpoint interop: sharded run to step 8, resume SINGLE-CHIP
    out = str(tmp_path / "ck")
    full = run_simulation(p, materials=dm, write_snapshots=False,
                          backend="xla", log=lambda s: None)
    run_simulation(p, materials=dm, out_dir=out, write_snapshots=False,
                   checkpoint_every=8, shard="2", log=lambda s: None)
    for f in glob.glob(out + "/ckpt*.npz"):
        if int(os.path.basename(f)[4:-4]) > 8:
            os.remove(f)
    resumed = run_simulation(p, materials=dm, out_dir=out,
                             write_snapshots=False, resume=True,
                             backend="xla", log=lambda s: None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_allclose(
            np.asarray(getattr(resumed.state, c)),
            np.asarray(getattr(full.state, c)),
            rtol=0, atol=1e-14,
        )


def test_dispersive_sar_energy_balance():
    """The discrete energy books close: in a source-free ring-down
    through a uniform Debye medium, the field energy lost equals the
    accumulated dissipation integral (E.dP/dt + sigma E_mid^2 work is
    the very term the update was derived with)."""
    from fdtd_tpu import diagnostics
    from fdtd_tpu.runner import initial_state

    n = 10
    base = _box(n, 1e-12, 4, mode=Mode.VALIDATION, dtype="float64")
    from fdtd_tpu.analytic import mode_constants

    f_vac, _ = mode_constants(base)
    per_period = 40
    dt = 1.0 / (f_vac * per_period)
    p = _box(n, dt, 12 * per_period, mode=Mode.VALIDATION, dtype="float64")
    dm = _uniform_debye(p, eps_inf=1.0, d_eps=0.15,
                        tau=1.0 / (2 * np.pi * 2.0e10), sigma=0.05)
    e0 = float(diagnostics.total_energy(p, initial_state(p)))
    res = run_simulation(p, materials=dm, accumulate_power=True,
                         write_snapshots=False, backend="xla",
                         log=lambda s: None)
    e1 = float(diagnostics.total_energy(p, res.state))
    dissipated = float(np.asarray(res.power_j, np.float64).sum()) \
        * p.spatial_step**3
    lost = e0 - e1
    assert lost > 0.2 * e0  # the medium genuinely absorbed
    # NOTE: diagnostics.total_energy is the vacuum-coefficient Yee sum;
    # in a dispersive medium the stored energy also lives in P, and the
    # staggered-time energy definition differs at O(w dt) — 15%
    # agreement pins that the accumulator measures real physics, not a
    # mislabeled quantity (sigma|E|^2 alone would be ~3x off here).
    np.testing.assert_allclose(dissipated, lost, rtol=0.15)


# ---------------------------------------------------------------------------
# Dispersive x PML (r5, VERDICT r4 #4): the ADE chain through the open
# boundary — ops/dispersive.make_dispersive_pml_step documents why the
# composition is algebraically exact (E gains cb*psi; P gains k2*cb*psi).


def _center_debye(p, eps_inf=1.0, d_eps=4.0, tau=3e-12, half=3):
    """A Debye cube at the cavity center, clear of the absorber."""
    K, J, I = p.maxk, p.maxj, p.maxi
    de = np.zeros((K, J, I))
    tu = np.full((K, J, I), tau)
    c = (K // 2, J // 2, I // 2)
    de[c[0]-half:c[0]+half, c[1]-half:c[1]+half, c[2]-half:c[2]+half] = d_eps
    return DebyeMaterials(
        base=Materials(eps_r=np.full((K, J, I), eps_inf), sigma=None),
        d_eps=de, tau=tu,
    )


def test_dispersive_pml_deps_zero_matches_lossy_pml():
    """d_eps = 0: the ADE+CPML composition reduces to the lossy CPML
    path (same algebra, different coefficient expressions -> tight
    allclose, not bit-equal)."""
    p = _box(12, 1e-12, 30, dtype="float64")
    from fdtd_tpu.ops.cpml import PMLConfig

    cfg = PMLConfig(cells=3)
    plain = water_block(p)
    dm = DebyeMaterials(
        base=plain,
        d_eps=np.zeros((p.maxk, p.maxj, p.maxi)),
        tau=np.zeros((p.maxk, p.maxj, p.maxi)),
    )
    want = run_simulation(p, materials=plain, pml=cfg, backend="xla",
                          write_snapshots=False, log=lambda s: None)
    got = run_simulation(p, materials=dm, pml=cfg, backend="xla",
                         write_snapshots=False, log=lambda s: None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.state, c)),
            np.asarray(getattr(want.state, c)),
            rtol=1e-12, atol=1e-16, err_msg=c,
        )


def test_dispersive_pml_inert_until_wave_arrives():
    """With the pulse confined to the interior, psi stays identically
    zero and the ADE+CPML run is BIT-equal to the closed-cavity ADE run
    (the correction is exactly inert outside the slabs; the k2*dE P fix
    adds exact zeros)."""
    import jax.numpy as jnp

    from fdtd_tpu.ops.cpml import PMLConfig, init_psi
    from fdtd_tpu.ops.dispersive import (
        make_dispersive_chunk_runner,
        make_dispersive_pml_chunk_runner,
        zero_polarization,
    )
    from fdtd_tpu.step import scan_inputs
    from fdtd_tpu.params import time_values
    from tests.test_pml import _solenoidal_pulse

    steps = 6
    p = _box(40, 1e-12, steps, mode=Mode.VALIDATION, dtype="float64")
    cfg = PMLConfig(cells=8)
    dm = _center_debye(p)
    s0 = _solenoidal_pulse(p, radius=1.5, cutoff=5.0)
    xs = scan_inputs(p, time_values(p)[:steps])
    P0 = zero_polarization(p)

    run_c = make_dispersive_chunk_runner(p, dm)
    (want, _), _, _, _ = run_c((s0, P0), xs, None, None)

    run_o = make_dispersive_pml_chunk_runner(p, dm, cfg)
    (got, _, psi), _, _, _ = run_o((s0, P0, init_psi(p, cfg)), xs,
                                   None, None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, c)), np.asarray(getattr(want, c)),
            err_msg=c,
        )
    for name in ("hx_z", "ex_y", "ez_y"):
        assert float(jnp.abs(getattr(psi, name)).max()) == 0.0, name


def test_dispersive_pml_ring_down_bounded_by_each_mechanism():
    """A Debye cube radiating through the absorber: the combined decay
    is faster than EITHER mechanism alone — after ~4 transit times the
    residual energy sits below both the dielectric-only (PEC cavity)
    and the radiation-only (vacuum PML) runs."""
    from fdtd_tpu import diagnostics
    from fdtd_tpu.ops.cpml import PMLConfig, init_psi, make_pml_chunk_runner
    from fdtd_tpu.ops.dispersive import (
        make_dispersive_chunk_runner,
        make_dispersive_pml_chunk_runner,
        zero_polarization,
    )
    from fdtd_tpu.step import scan_inputs
    from fdtd_tpu.params import time_values
    from tests.test_pml import _solenoidal_pulse

    n, steps = 32, 400
    p = _box(n, 1e-12, steps, mode=Mode.VALIDATION)
    cfg = PMLConfig(cells=8)
    dm = _center_debye(p, d_eps=6.0, tau=2e-12, half=4)
    s0 = _solenoidal_pulse(p, radius=3.0)
    xs = scan_inputs(p, time_values(p)[:steps])
    P0 = zero_polarization(p)

    def energy(s):
        return float(diagnostics.e_energy(p, s)) + float(
            diagnostics.h_energy(p, s))

    e0 = energy(s0)
    # dielectric only (closed cavity)
    run_d = make_dispersive_chunk_runner(p, dm)
    (sd, _), _, _, _ = run_d((s0, P0), xs, None, None)
    e_diel = energy(sd)
    # radiation only (vacuum + PML)
    run_r = make_pml_chunk_runner(p, cfg)
    (sr, _), _ = run_r((s0, init_psi(p, cfg)), xs, None)
    e_rad = energy(sr)
    # both
    run_b = make_dispersive_pml_chunk_runner(p, dm, cfg)
    (sb, _, _), _, _, _ = run_b((s0, P0, init_psi(p, cfg)), xs,
                                None, None)
    e_both = energy(sb)

    assert e_diel < 0.9 * e0       # the dielectric genuinely absorbs
    assert e_rad < 1e-3 * e0       # the absorber genuinely absorbs
    # combined: the open boundary drains what the dielectric alone
    # cannot (orders below the closed-cavity dispersive run) ...
    assert e_both < 0.05 * e_diel
    assert e_both < 1e-3 * e0
    # ... while the cube only mildly delays the drain (it stores energy
    # and reflects at its interface, so e_both can sit slightly ABOVE
    # the pure-vacuum run; measured ratio ~2.1)
    assert e_both < 5 * e_rad
    assert np.isfinite(e_both) and e_both > 0


def test_dispersive_pml_runner_monitors_sar_and_checkpoint(tmp_path):
    """run_simulation composes --dispersive --pml with --sar, --dft and
    --probe; checkpoints carry BOTH pol_* and psi_* aux arrays and the
    resumed run is bit-equal to the uninterrupted one."""
    import glob
    import os

    from fdtd_tpu.dft import DftConfig
    from fdtd_tpu.io.checkpoint import load_aux
    from fdtd_tpu.ops.cpml import PMLConfig

    p = _box(10, 1e-12, 16)
    cfg = PMLConfig(cells=2)
    dm = water_debye_load(p, lo=(0.35,) * 3, hi=(0.65,) * 3,
                          sigma_ion25=0.5)
    res = run_simulation(p, materials=dm, pml=cfg, write_snapshots=False,
                         accumulate_power=True,
                         probes=ProbeSet(((5, 5, 5),)),
                         dft=DftConfig((p.source.frequency,)),
                         backend="xla", log=lambda s: None)
    assert res.probes.values.shape[0] == res.iterations
    assert np.isfinite(res.dft.phasors).all()
    assert float(np.asarray(res.power_j).max()) > 0.0

    out_a = str(tmp_path / "a")
    out_b = str(tmp_path / "b")
    ra = run_simulation(p, materials=dm, pml=cfg, out_dir=out_a,
                        write_snapshots=False, checkpoint_every=8,
                        backend="xla", log=lambda s: None)
    aux = load_aux(sorted(glob.glob(out_a + "/ckpt*.npz"))[0])
    assert all(f"psi_{n}" in aux for n in ("hx_y", "ez_x"))
    assert all(n in aux for n in ("pol_x", "pol_y", "pol_z"))
    run_simulation(p, materials=dm, pml=cfg, out_dir=out_b,
                   write_snapshots=False, checkpoint_every=8,
                   backend="xla", log=lambda s: None)
    for f in glob.glob(out_b + "/ckpt*.npz"):
        if int(os.path.basename(f)[4:-4]) > 8:
            os.remove(f)
    rb = run_simulation(p, materials=dm, pml=cfg, out_dir=out_b,
                        write_snapshots=False, resume=True,
                        backend="xla", log=lambda s: None)
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ra.state, c)),
            np.asarray(getattr(rb.state, c)), err_msg=c,
        )
