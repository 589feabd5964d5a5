"""Heterogeneous-material (lossy dielectric) update tests — capability
extension over the vacuum-only reference (BASELINE config #2)."""

import dataclasses

import jax
import numpy as np

from fdtd_tpu import diagnostics
from fdtd_tpu.params import Mode, time_values
from fdtd_tpu.state import Materials, init_validation, water_block, zeros
from fdtd_tpu.step import make_chunk_runner, make_step, scan_inputs


def test_uniform_vacuum_materials_match_scalar_path(tiny_params):
    p = tiny_params
    K, J, I = p.maxk, p.maxj, p.maxi
    mats = Materials(eps_r=np.ones((K, J, I)), sigma=np.zeros((K, J, I)))
    s0 = init_validation(p)
    step_scalar = jax.jit(make_step(p))
    step_mats = jax.jit(make_step(p, materials=mats))
    s_a, s_b = s0, s0
    ts, amps = scan_inputs(p, time_values(p)[:8])
    for t, a in zip(ts, amps):
        s_a = step_scalar(s_a, (t, a))
        s_b = step_mats(s_b, (t, a))
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_allclose(
            np.asarray(getattr(s_a, c)), np.asarray(getattr(s_b, c)), atol=1e-15, rtol=1e-10, err_msg=c
        )


def test_lossy_block_dissipates_energy(tiny_params):
    """Pure conductivity (eps_r=1) so the vacuum energy functional is the
    right Lyapunov quantity: sigma>0 must drain it monotonically (modulo the
    staggered-time oscillation, which a 50% bar dwarfs)."""
    p = tiny_params
    mats = water_block(p, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0), eps_r=1.0, sigma=5.0)
    s = init_validation(p)
    step = jax.jit(make_step(p, materials=mats))
    e0 = float(diagnostics.total_energy(p, s))
    ts, amps = scan_inputs(p, time_values(p))
    for t, a in zip(ts, amps):
        s = step(s, (t, a))
    e1 = float(diagnostics.total_energy(p, s))
    assert np.isfinite(e1)
    assert e1 < e0 * 0.5


def test_power_deposition_accumulates(tiny_params):
    p = dataclasses.replace(tiny_params, dtype="float32")
    mats = water_block(p, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0), eps_r=5.0, sigma=1.0)
    run = make_chunk_runner(p, materials=mats, accumulate_power=True)
    from fdtd_tpu.step import zero_power_acc

    s = init_validation(p)
    xs = scan_inputs(p, time_values(p)[:20])
    s, acc = run(s, xs, zero_power_acc(p))
    acc = np.asarray(acc)
    assert acc.shape == (p.maxk, p.maxj, p.maxi)
    assert acc.min() >= 0.0 and acc.max() > 0.0


def test_higher_eps_slows_wave(tiny_params):
    """Sanity: a high-eps fill lowers the resonant dynamics (fields differ)."""
    p = tiny_params
    mats = water_block(p, lo=(0, 0, 0), hi=(1, 1, 1), eps_r=4.0, sigma=0.0)
    s_v, s_m = init_validation(p), init_validation(p)
    step_v = jax.jit(make_step(p))
    step_m = jax.jit(make_step(p, materials=mats))
    ts, amps = scan_inputs(p, time_values(p)[:15])
    for t, a in zip(ts, amps):
        s_v = step_v(s_v, (t, a))
        s_m = step_m(s_m, (t, a))
    dif = float(np.abs(np.asarray(s_v.ey) - np.asarray(s_m.ey)).max())
    assert dif > 1e-3


def test_uniform_mu_arrays_match_scalar_path(tiny_params):
    """mu_r == 1 arrays must reproduce the vacuum evolution exactly."""
    from fdtd_tpu.state import Materials

    p = tiny_params
    K, J, I = p.maxk, p.maxj, p.maxi
    mats = Materials(mu_r=np.ones((K, J, I)))
    s_a = init_validation(p)
    s_b = init_validation(p)
    step_v = jax.jit(make_step(p))
    step_m = jax.jit(make_step(p, materials=mats))
    xs = scan_inputs(p, time_values(p)[:10])
    for t, a in zip(*xs):
        s_a = step_v(s_a, (t, a))
        s_b = step_m(s_b, (t, a))
    for c in ["ex", "ey", "ez", "hx", "hy", "hz"]:
        np.testing.assert_allclose(
            np.asarray(getattr(s_a, c)), np.asarray(getattr(s_b, c)),
            atol=1e-15, rtol=1e-12, err_msg=c,
        )


def test_higher_mu_slows_wave(tiny_params):
    """A high-permeability block changes the evolution (mu_r is live)."""
    from fdtd_tpu.state import Materials

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
    K, J, I = p.maxk, p.maxj, p.maxi
    mu = np.ones((K, J, I))
    mu[:, :, :] = 1.0
    mu[K // 4 : 3 * K // 4, J // 4 : 3 * J // 4, I // 4 : 3 * I // 4] = 9.0
    s_v = zeros(p)
    s_m = zeros(p)
    step_v = jax.jit(make_step(p))
    step_m = jax.jit(make_step(p, materials=Materials(mu_r=mu)))
    xs = scan_inputs(p, time_values(p))
    for t, a in zip(*xs):
        s_v = step_v(s_v, (t, a))
        s_m = step_m(s_m, (t, a))
    dif = float(np.abs(np.asarray(s_v.hx) - np.asarray(s_m.hx)).max())
    assert dif > 1e-12
    assert np.isfinite(np.asarray(s_m.hx)).all()


def _ferrite_water_scene(p):
    """Heterogeneous eps, sigma AND mu: a water block plus a ferrite slab."""
    import numpy as np

    from fdtd_tpu.state import Materials

    K, J, I = p.maxk, p.maxj, p.maxi
    er = np.ones((K, J, I))
    sg = np.zeros((K, J, I))
    mu = np.ones((K, J, I))
    er[2 : K - 2, 2 : J - 2, 2 : I - 2] = 20.0
    sg[2 : K - 2, 2 : J - 2, 2 : I - 2] = 0.8
    mu[K // 2 :, : J // 2, :] = 4.0  # ferrite slab
    return Materials(eps_r=er, sigma=sg, mu_r=mu)


def test_load_shape_masks_geometry():
    """Sphere/cylinder cell masks: volumes match the analytic shapes to
    the staircase tolerance and respect the expected symmetries."""
    from fdtd_tpu.params import Mode, Params
    from fdtd_tpu.state import cylinder_mask, sphere_mask

    n = 20
    p = Params(length=n * 1e-3, width=n * 1e-3, height=n * 1e-3,
               spatial_step=1e-3, time_step=1e-12, simulation_time=1e-12,
               sampling_rate=10**9, mode=Mode.VALIDATION)
    sm = sphere_mask(p, radius=0.3)
    want = 4.0 / 3.0 * np.pi * (0.3 * n) ** 3
    np.testing.assert_allclose(sm.sum(), want, rtol=0.05)
    # centered: symmetric under each axis flip
    for ax in range(3):
        np.testing.assert_array_equal(sm, np.flip(sm, axis=ax))

    cm = cylinder_mask(p, radius=0.25, lo=0.2, hi=0.8)
    height = int(0.8 * n) - int(0.2 * n)
    want_c = np.pi * (0.25 * n) ** 2 * height
    np.testing.assert_allclose(cm.sum(), want_c, rtol=0.05)
    # every z slab inside [lo, hi) carries the same disk
    disk = cm[int(0.2 * n)]
    for k in range(int(0.2 * n), int(0.8 * n)):
        np.testing.assert_array_equal(cm[k], disk)
    assert not cm[: int(0.2 * n)].any() and not cm[int(0.8 * n):].any()


def test_load_shape_cli_end_to_end(tmp_path):
    """--load-shape sphere: SAR deposits inside the sphere only, and the
    thermal hot spot sits inside it; --load-shape without --water-block
    errors cleanly."""
    from fdtd_tpu.cli import main
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays
    from fdtd_tpu.params import parse_params_text
    from fdtd_tpu.state import sphere_mask

    params = tmp_path / "p.txt"
    params.write_text("0.02\n0.02\n0.02\n0.001\n1e-12\n2e-11\n1000000000\n1\n")
    out = tmp_path / "o"
    rc = main([str(params), "--water-block", "--load-shape", "sphere",
               "--sar", "--thermal", "10", "--out", str(out),
               "--backend", "xla"])
    assert rc == 0
    # the CLI's grid derivation applies the C %f float32 rounding
    # (QUIRKS #7), so build the mask from the SAME parsed params
    p = parse_params_text(params.read_text())
    mask = sphere_mask(p)
    sar = read_vtr_cell_arrays(str(out / "sar.vtr"))["power_j_m3"]
    assert float(sar[~mask].max()) == 0.0
    assert float(sar[mask].max()) > 0.0
    T = read_vtr_cell_arrays(str(out / "temperature.vtr"))["temperature_c"]
    hot = np.unravel_index(int(T.argmax()), T.shape)
    assert mask[hot]

    assert main([str(params), "--load-shape", "sphere"]) == 1
