"""On-the-fly DFT phasors (fdtd_tpu/dft.py).

The physics pin: validation mode is a monochromatic TE101 standing wave
Ey ~ pattern(x,z) * cos(2 pi f101 t), so the DFT at f101 over whole
periods must return the cell-centered spatial pattern as a (near-)real
phasor, with the other components near zero.
"""

import numpy as np
import pytest

from fdtd_tpu import diagnostics
from fdtd_tpu.analytic import mode_constants
from fdtd_tpu.dft import (
    DftConfig,
    dft_weights,
    finalize,
    zero_dft_acc,
)
from fdtd_tpu.params import Mode, Params
from fdtd_tpu.runner import initial_state, run_simulation
from fdtd_tpu.state import water_block


def test_dft_config_validation():
    with pytest.raises(ValueError):
        DftConfig(())
    with pytest.raises(ValueError):
        DftConfig((2.45e9, -1.0))
    assert DftConfig((2.45e9,)).nf == 1


def test_dft_weights_normalization():
    """2/N sum cos^2 = 1 over whole periods (the amplitude calibration)
    and the quadratures are orthogonal."""
    f = 1.0e9
    n_per = 32
    dt = 1.0 / (f * n_per)
    ts = np.arange(4 * n_per) * dt
    cw, sw = dft_weights(DftConfig((f,)), ts)
    n = len(ts)
    np.testing.assert_allclose(2.0 / n * (cw[:, 0] ** 2).sum(), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(2.0 / n * (sw[:, 0] ** 2).sum(), 1.0,
                               rtol=1e-6)
    assert abs((cw[:, 0] * sw[:, 0]).sum()) < 1e-3


def _validation_params(n=10, periods=3, per_period=32):
    """A validation-mode box whose dt divides the TE101 period exactly."""
    dx = 1e-3
    base = Params(
        length=n * dx, width=n * dx, height=n * dx, spatial_step=dx,
        time_step=1e-13, simulation_time=1e-12, sampling_rate=10**9,
        mode=Mode.VALIDATION, dtype="float32",
    )
    f101, _ = mode_constants(base)
    dt = 1.0 / (f101 * per_period)
    assert dt < base.cfl_limit()
    steps = periods * per_period
    return Params(
        length=n * dx, width=n * dx, height=n * dx, spatial_step=dx,
        time_step=dt, simulation_time=(steps - 0.5) * dt,
        sampling_rate=10**9, mode=Mode.VALIDATION, dtype="float32",
    ), f101


def test_dft_extracts_te101_pattern():
    """DFT at f101 over 3 whole periods returns the cell-centered Ey
    pattern as a near-real phasor; Ex/Ez stay near zero."""
    p, f101 = _validation_params()
    res = run_simulation(
        p, write_snapshots=False, dft=DftConfig((f101,)),
        backend="xla", log=lambda s: None,
    )
    assert res.dft is not None and res.dft.steps > 0
    ph = res.dft.phasors[0]  # (3, K, J, I) complex
    # reference pattern: the t=0 initial condition IS the peak cosine
    # amplitude, so its cell means are the expected |phasor|
    mex, mey, mez = (np.asarray(a) for a in
                     diagnostics._e_cell_means(p, initial_state(p)))
    peak = np.abs(mey).max()
    assert peak > 0.5
    # The discrete mode rings at the numerical frequency with a small
    # GLOBAL phase (leapfrog half-step offset + dispersion drift vs the
    # analytic f101 probe) — spatially uniform, so rotating it out must
    # leave a near-real phasor matching the pattern sign for sign.
    hot = np.unravel_index(np.abs(ph[1]).argmax(), ph[1].shape)
    theta = np.angle(ph[1][hot] * np.sign(mey[hot]))
    assert abs(theta) < 0.45  # the offset is small
    rot = ph[1] * np.exp(-1j * theta)
    np.testing.assert_allclose(rot.real, mey, atol=0.06 * peak)
    assert np.abs(rot.imag).max() < 0.06 * peak
    assert np.abs(ph[0]).max() < 0.05 * peak
    assert np.abs(ph[2]).max() < 0.05 * peak
    # magnitude map agrees with the pattern too
    np.testing.assert_allclose(res.dft.magnitude(0), np.abs(mey),
                               atol=0.12 * peak)


def test_dft_chunk_runner_composes_with_sar():
    """--sar and --dft share one scan: the SAR accumulator matches a
    DFT-free run bit for bit."""
    dx = 1e-3
    n = 8
    p = Params(
        length=n * dx, width=n * dx, height=n * dx, spatial_step=dx,
        time_step=1e-12, simulation_time=2e-11, sampling_rate=10**9,
        mode=Mode.COMPUTATION, dtype="float32",
    )
    mats = water_block(p)
    want = run_simulation(
        p, materials=mats, accumulate_power=True, write_snapshots=False,
        backend="xla", log=lambda s: None,
    )
    got = run_simulation(
        p, materials=mats, accumulate_power=True, write_snapshots=False,
        backend="xla", dft=DftConfig((p.source.frequency,)),
        log=lambda s: None,
    )
    np.testing.assert_array_equal(np.asarray(got.power_j),
                                  np.asarray(want.power_j))
    for c in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got.state, c)),
            np.asarray(getattr(want.state, c)),
        )
    # CW power from the phasor is nonnegative and lives in the load
    cw = got.dft.cw_power(mats.sigma, 0)
    assert cw.min() >= 0.0
    assert cw.max() > 0.0


def test_dft_unsupported_backend_raises():
    """A DFT run takes the jnp step; a removed tier name or an unknown
    backend is refused."""
    p, f = _validation_params(n=8, periods=1)
    with pytest.raises(ValueError, match="removed"):
        run_simulation(p, dft=DftConfig((f,)), write_snapshots=False,
                       backend="pallas_temporal", log=lambda s: None)
    with pytest.raises(ValueError, match="unknown backend"):
        run_simulation(p, dft=DftConfig((f,)), write_snapshots=False,
                       backend="cuda", log=lambda s: None)


def test_dft_guard_combinations(tmp_path):
    # r4: monitor accumulators RIDE checkpoints (VERDICT r3 #3) — a
    # checkpointed DFT run completes and stores the running sums as aux
    p, f = _validation_params(n=8, periods=1)
    res = run_simulation(p, dft=DftConfig((f,)), checkpoint_every=5,
                         out_dir=str(tmp_path), write_snapshots=False,
                         log=lambda s: None)
    assert res.dft is not None
    import glob

    import numpy as np_

    cks = sorted(glob.glob(str(tmp_path) + "/ckpt*.npz"))
    assert cks
    with np_.load(cks[-1]) as z:
        assert "aux_dft_re" in z or "dft_re" in z or any(
            "dft_re" in k for k in z.files), list(z.files)


def test_dft_sharded_matches_single_chip():
    """--dft under --shard (the jnp shard_map scan): phasors match the
    single-chip monitored run — GSPMD partitions the very same cell-mean
    slice arithmetic."""
    p, f101 = _validation_params(n=8, periods=2)
    cfg = DftConfig((f101,))
    single = run_simulation(p, dft=cfg, write_snapshots=False,
                            backend="xla", log=lambda s: None)
    sharded = run_simulation(p, dft=cfg, shard="2", write_snapshots=False,
                             backend="xla", log=lambda s: None)
    np.testing.assert_array_equal(sharded.dft.phasors, single.dft.phasors)
    for c in ("ex", "ey", "ez"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sharded.state, c)),
            np.asarray(getattr(single.state, c)),
        )


def test_dft_cli_end_to_end(tmp_path):
    from fdtd_tpu.cli import main
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    params = tmp_path / "p.txt"
    params.write_text("0.01\n0.01\n0.01\n0.001\n1e-12\n2e-11\n1000000000\n1\n")
    out = tmp_path / "o"
    rc = main([str(params), "--water-block", "--dft", "2.45e10,2.45e9",
               "--out", str(out), "--backend", "xla", "--no-output"])
    assert rc == 0  # --no-output skips the vtr writes cleanly

    rc = main([str(params), "--water-block", "--dft", "2.45e10",
               "--out", str(out), "--backend", "xla"])
    assert rc == 0
    arrs = read_vtr_cell_arrays(str(out / "dft_00.vtr"))
    for name in ("ex_re", "ex_im", "ey_re", "ey_im", "ez_re", "ez_im",
                 "e_mag", "cw_power_w_m3"):
        assert name in arrs, name
    assert float(arrs["e_mag"].max()) > 0.0
    assert float(arrs["cw_power_w_m3"].min()) >= 0.0

    assert main([str(params), "--dft", "not-a-number"]) == 1
    # r4: --dft composes with checkpointing (phasor sums ride as aux)
    assert main([str(params), "--dft", "2.45e9", "--out", str(out),
                 "--checkpoint-every", "5"]) == 0

    # --dft composes with --pml (open-boundary phasor patterns) via the
    # xla PML scan
    rc = main([str(params), "--dft", "2.45e10", "--pml", "3",
               "--out", str(tmp_path / "pml"), "--backend", "xla"])
    assert rc == 0
    arrs = read_vtr_cell_arrays(str(tmp_path / "pml" / "dft_00.vtr"))
    assert np.isfinite(arrs["e_mag"]).all()


def test_dft_eh_standing_wave_poynting_vanishes():
    """TE101 is a standing mode: E and H oscillate in time quadrature, so
    the cycle-averaged Poynting S = 1/2 Re(E x H*) must vanish against
    the |E||H| scale — but only once the leapfrog half-step phase
    correction is applied to the H phasors (finalize); undoing it leaks
    ~sin(w dt/2) ~ 10% of the scale."""
    p, f101 = _validation_params()
    res = run_simulation(
        p, write_snapshots=False, backend="xla",
        dft=DftConfig((f101,), fields="eh"), log=lambda s: None,
    )
    assert res.dft.fields == "eh"
    ph = res.dft.phasors[0]
    assert ph.shape[0] == 6
    e_scale = float(np.abs(ph[:3]).max())
    h_scale = float(np.abs(ph[3:]).max())
    assert e_scale > 0.5 and h_scale > 0.0
    S = res.dft.poynting(0)
    scale = e_scale * h_scale
    assert np.abs(S).max() < 0.04 * scale, (np.abs(S).max(), scale)

    # undo the correction: the uncorrected product leaks an order of
    # magnitude more
    w = 2 * np.pi * f101
    raw = ph.copy()
    raw[3:] = raw[3:] * np.exp(-0.5j * w * p.time_step)
    S_raw = 0.5 * np.real(np.cross(raw[:3], np.conj(raw[3:]), axis=0))
    assert np.abs(S_raw).max() > 2.5 * np.abs(S).max()

    # fields='e' results refuse to compute Poynting
    res_e = run_simulation(
        p, write_snapshots=False, backend="xla",
        dft=DftConfig((f101,)), log=lambda s: None,
    )
    with pytest.raises(ValueError, match="eh"):
        res_e.dft.poynting(0)
    with pytest.raises(ValueError, match="'e' or 'eh'"):
        DftConfig((1e9,), fields="x")


def test_dft_memory_warning():
    """A multi-GB accumulator request is warned about up front (RunResult
    warnings + log), not discovered as an OOM mid-run."""
    from fdtd_tpu.runner import _dft_memory_note

    # 512^3, 4 frequencies, eh: 4*6*512^3*8 B = 24 GB -> warns
    dx = 1e-3
    big = Params(length=0.512, width=0.512, height=0.512, spatial_step=dx,
                 time_step=1e-12, simulation_time=1e-12,
                 sampling_rate=10**9, mode=Mode.VALIDATION, dtype="float32")
    cfg = DftConfig((1e9, 2e9, 3e9, 4e9), fields="eh")
    note = _dft_memory_note(big, cfg)
    assert note and "24.0 GB" in note, note
    # one e-only frequency at 256^3: 0.375 GB -> silent
    mid = Params(length=0.256, width=0.256, height=0.256, spatial_step=dx,
                 time_step=1e-12, simulation_time=1e-12,
                 sampling_rate=10**9, mode=Mode.VALIDATION, dtype="float32")
    assert _dft_memory_note(mid, DftConfig((1e9,))) is None

    # wiring: a small real run stays warning-free
    p, f = _validation_params(n=8, periods=1)
    msgs = []
    res = run_simulation(p, dft=DftConfig((f,), fields="eh"),
                         write_snapshots=False, backend="xla",
                         log=msgs.append)
    assert not any("GB of device memory" in m for m in msgs)
    assert not any("GB of device memory" in w for w in res.warnings)


def _comp_box(n, steps, dtype="float32"):
    return Params(
        length=n * 1e-3, width=n * 1e-3, height=n * 1e-3,
        spatial_step=1e-3, time_step=1e-12,
        simulation_time=(steps - 0.5) * 1e-12, sampling_rate=10**9,
        mode=Mode.COMPUTATION, dtype=dtype,
    )
