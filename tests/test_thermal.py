"""Thermal solve (fdtd_tpu/thermal.py): the SAR -> temperature coupling.

Capability extension — the reference never closes its own product loop
(a microwave oven that heats nothing); these tests pin the heat-equation
discretization against closed forms: adiabatic exactness, discrete
conservation + the max principle (the positivity-preserving dt bound),
and free-space Gaussian diffusion against the analytic kernel.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from fdtd_tpu.params import Mode, Params
from fdtd_tpu.thermal import (
    ThermalMaterials,
    air_thermal,
    make_thermal_step,
    run_thermal,
    stable_dt,
    water_thermal,
)


def _box_params(n, dtype="float64"):
    return Params(
        length=n * 1e-3, width=n * 1e-3, height=n * 1e-3,
        spatial_step=1e-3, time_step=1e-12, simulation_time=1e-11,
        sampling_rate=10**9, mode=Mode.VALIDATION, dtype=dtype,
    )


def test_thermal_adiabatic_exact():
    """k = 0: every cell heats by exactly q * t / rho_c — the scan's
    repeated adds land on the closed form to fp64 rounding, including
    the shortened last step."""
    p = _box_params(12)
    shape = (p.maxk, p.maxj, p.maxi)
    rng = np.random.default_rng(0)
    rho_c = rng.uniform(1e3, 5e6, shape)
    q = rng.uniform(0.0, 1e6, shape)
    tm = ThermalMaterials(rho_c=rho_c, k=np.zeros(shape))
    duration = 7.3
    res = run_thermal(p, tm, q, duration, ambient=20.0, dt=0.5)
    want = 20.0 + q * duration / rho_c
    np.testing.assert_allclose(np.asarray(res.temperature), want,
                               rtol=1e-12, atol=0)


def test_thermal_conservation_and_max_principle():
    """q = 0, insulated walls, mixed air/water materials: total heat
    content sum(rho_c * T) is conserved and T stays inside the initial
    [min, max] (the positivity-preserving stable_dt makes every update
    weight non-negative)."""
    p = _box_params(16)
    tm = water_thermal(p)  # water block in air — discontinuous rho_c, k
    rng = np.random.default_rng(1)
    T0 = rng.uniform(10.0, 90.0, (p.maxk, p.maxj, p.maxi))
    dt = stable_dt(p, tm)
    assert dt > 0
    res = run_thermal(p, tm, np.zeros_like(T0), duration=200 * dt,
                      t0=T0, dt=dt)
    T = np.asarray(res.temperature)
    heat0 = float((tm.rho_c * T0).sum())
    heat1 = float((np.asarray(tm.rho_c) * T).sum())
    np.testing.assert_allclose(heat1, heat0, rtol=1e-12)
    assert T.min() >= T0.min() - 1e-9
    assert T.max() <= T0.max() + 1e-9
    # diffusion genuinely happened
    assert T.max() - T.min() < 0.999 * (T0.max() - T0.min())


def test_thermal_gaussian_matches_analytic():
    """Uniform medium: a Gaussian hot spot diffuses with variance
    sigma^2 + 2 alpha t; the discrete peak decay matches the analytic
    free-space kernel to ~1% while the walls are far away."""
    n = 32
    p = _box_params(n)
    shape = (p.maxk, p.maxj, p.maxi)
    rho_c, k = 2.0e6, 0.5
    tm = ThermalMaterials(rho_c=np.full(shape, rho_c), k=np.full(shape, k))
    alpha = k / rho_c
    dx = p.spatial_step
    sig = 3.0 * dx
    c = np.array([s / 2 - 0.5 for s in shape]) * dx
    kk, jj, ii = np.meshgrid(*[np.arange(s) * dx for s in shape],
                             indexing="ij")
    r2 = (kk - c[0]) ** 2 + (jj - c[1]) ** 2 + (ii - c[2]) ** 2
    amp = 50.0
    T0 = 20.0 + amp * np.exp(-r2 / (2 * sig**2))
    t_end = 2.0 * sig**2 / alpha  # variance grows 5x: a real decay
    res = run_thermal(p, tm, np.zeros(shape), duration=t_end, t0=T0)
    T = np.asarray(res.temperature)
    peak_want = amp * (sig**2 / (sig**2 + 2 * alpha * t_end)) ** 1.5
    peak_got = T.max() - 20.0
    np.testing.assert_allclose(peak_got, peak_want, rtol=0.02)
    # the whole field, not just the peak: compare against the diffused
    # Gaussian (walls at ~5 sigma_final keep the image terms negligible)
    sig2_t = sig**2 + 2 * alpha * t_end
    want = 20.0 + amp * (sig**2 / sig2_t) ** 1.5 * np.exp(-r2 / (2 * sig2_t))
    np.testing.assert_allclose(T, want, atol=0.02 * amp)


def test_thermal_two_slab_interface_flux():
    """Harmonic-mean face conductivity: the two-slab composite relaxes
    toward the heat-content-weighted equilibrium monotonically, and the
    early-time interface flux matches the series-resistance closed form
    (k_face = 2 k1 k2 / (k1 + k2))."""
    p = _box_params(8)
    shape = (p.maxk, p.maxj, p.maxi)
    k1, k2 = 0.2, 5.0
    rc = np.full(shape, 1e6)
    kmap = np.full(shape, k1)
    half = shape[0] // 2
    kmap[half:] = k2
    tm = ThermalMaterials(rho_c=rc, k=kmap)
    T0 = np.where(np.arange(shape[0])[:, None, None] < half, 80.0, 20.0)
    T0 = np.broadcast_to(T0, shape).copy()
    dt = stable_dt(p, tm)
    step = make_thermal_step(p, tm, np.zeros(shape), dt)
    T1 = np.asarray(step(jnp.asarray(T0)))
    # only the two rows touching the interface moved, by +-dt*flux/(rc dx)
    kf = 2 * k1 * k2 / (k1 + k2)
    dT = dt * kf * (80.0 - 20.0) / (1e6 * p.spatial_step**2)
    np.testing.assert_allclose(T1[half - 1], 80.0 - dT, rtol=1e-12)
    np.testing.assert_allclose(T1[half], 20.0 + dT, rtol=1e-12)
    np.testing.assert_allclose(T1[: half - 1], 80.0)
    np.testing.assert_allclose(T1[half + 1 :], 20.0)


def test_thermal_cli_end_to_end(tmp_path):
    """--water-block --sar --thermal: the EM run's SAR map drives the
    cook; temperature.vtr + sar.vtr are written, the hot spot sits inside
    the water block, and --thermal without --sar is a clean error."""
    from fdtd_tpu.cli import main
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    params = tmp_path / "p.txt"
    # computation mode (source on) so sigma|E|^2 accumulates
    params.write_text("0.02\n0.02\n0.02\n0.001\n1e-12\n3e-11\n10\n1\n")
    out = tmp_path / "o"
    # fp64: a unit-amplitude source over 30 EM steps deposits ~1e-15
    # J/m^3, so the 30 s rise is ~1e-9 K — real but invisible in fp32
    rc = main([str(params), "--out", str(out), "--water-block", "--sar",
               "--thermal", "30", "--thermal-ambient", "20",
               "--dtype", "float64"])
    assert rc == 0
    sar = read_vtr_cell_arrays(str(out / "sar.vtr"))
    assert float(sar["power_j_m3"].max()) > 0
    temp = read_vtr_cell_arrays(str(out / "temperature.vtr"))
    T = temp["temperature_c"]
    assert float(T.max()) > 20.0  # strict: the load genuinely warmed
    hot = np.unravel_index(int(T.argmax()), T.shape)
    K = T.shape[0]
    lo, hi = int(0.3 * K), int(0.7 * K)
    assert all(lo <= h < hi for h in hot), (hot, lo, hi)
    # heating only where the load is (up to diffusion into the walls):
    # the air corner stays at ambient
    assert abs(float(T[0, 0, 0]) - 20.0) < 1e-6

    rc = main([str(params), "--out", str(tmp_path / "x"), "--sar",
               "--water-block", "--thermal", "-1"])
    assert rc == 1
    rc = main([str(params), "--out", str(tmp_path / "y"),
               "--thermal", "10"])
    assert rc == 1


def test_thermal_rise_resolves_in_fp32_no_x64(tmp_path):
    """Regression (r3 review): the integration carries the rise above
    ambient, so a sub-ulp-of-300K heating signal survives fp32 without
    the test harness's x64 flag.  Runs the real CLI in a fresh
    subprocess (default fp32, no jax_enable_x64) and checks the
    temperature map genuinely warmed at the deposition peak."""
    params = tmp_path / "p.txt"
    params.write_text("0.02\n0.02\n0.02\n0.001\n1e-12\n2e-11\n1000000000\n1\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    out = tmp_path / "o"
    proc = subprocess.run(
        [sys.executable, "-m", "fdtd_tpu", str(params), "--water-block",
         "--sar", "--thermal", "30", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    T = read_vtr_cell_arrays(str(out / "temperature.vtr"))["temperature_c"]
    q = read_vtr_cell_arrays(str(out / "sar.vtr"))["avg_power_w_m3"]
    assert float(T.max()) > 20.0  # strictly warmed, not a flat field
    hot = np.unravel_index(int(T.argmax()), T.shape)
    qh = np.unravel_index(int(np.asarray(q).argmax()), q.shape)
    assert hot == qh, (hot, qh)  # argmax of a constant would be (0,0,0)
    assert "rise" in proc.stdout


def test_thermal_steps_count_matches_integration():
    """ThermalResult.steps counts executed steps only: a duration that
    is an exact multiple of dt reports n_full, not n_full + 1."""
    p = _box_params(6)
    tm = air_thermal(p)
    shape = (p.maxk, p.maxj, p.maxi)
    res = run_thermal(p, tm, np.zeros(shape), duration=1.0, dt=0.25)
    assert res.steps == 4
    res = run_thermal(p, tm, np.zeros(shape), duration=1.1, dt=0.25)
    assert res.steps == 5  # 4 full + shortened remainder
