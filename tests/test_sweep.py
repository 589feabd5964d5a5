"""vmap design-sweep tests (BASELINE config #5)."""

import dataclasses

import jax
import numpy as np

from fdtd_tpu.params import Mode, time_values
from fdtd_tpu.state import water_block, zeros
from fdtd_tpu.step import make_step, scan_inputs
from fdtd_tpu.sweep import frequency_sweep, material_sweep


def test_frequency_sweep_matches_individual_runs(tiny_params):
    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION, dtype="float32")
    freqs = [2.45e10, 1.0e10, 5.0e9]
    res = frequency_sweep(p, freqs, n_steps=10)
    assert res.states.ex.shape[0] == 3
    assert res.e_energy.shape == (3,)

    # member 1 must equal a standalone run at that frequency
    from fdtd_tpu.params import SourceConfig

    p1 = dataclasses.replace(p, source=SourceConfig(frequency=freqs[1]))
    s = zeros(p1)
    step = jax.jit(make_step(p1))
    ts, amps = scan_inputs(p1, time_values(p1)[:10])
    for t, a in zip(ts, amps):
        s = step(s, (t, a))
    for c in ["ez", "hx", "ey"]:
        np.testing.assert_allclose(
            np.asarray(getattr(res.states, c))[1],
            np.asarray(getattr(s, c)),
            atol=1e-6,
            rtol=1e-5,
            err_msg=c,
        )
    # different frequencies produce different fields
    assert not np.allclose(np.asarray(res.states.ez)[0], np.asarray(res.states.ez)[2])


def test_frequency_sweep_sharded_matches_unsharded(tiny_params):
    """Batch axis over an 8-way mesh == unsharded vmap, bit-for-bit
    (BASELINE config #5 'optionally sharded'; VERDICT r1 next-item #9)."""
    from fdtd_tpu.sweep import batch_mesh

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION, dtype="float32")
    freqs = [2.45e10 * (1 + 0.05 * i) for i in range(8)]
    want = frequency_sweep(p, freqs, n_steps=8)
    mesh = batch_mesh(8, devices=jax.devices("cpu"))
    got = frequency_sweep(p, freqs, n_steps=8, mesh=mesh)
    # the batch really is distributed over all 8 devices
    assert len(got.states.ez.sharding.device_set) == 8
    for c in ["ez", "hx", "ey"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(got.states, c)), np.asarray(getattr(want.states, c)),
            err_msg=c,
        )
    np.testing.assert_array_equal(np.asarray(got.e_energy), np.asarray(want.e_energy))


def test_frequency_sweep_sharded_rejects_ragged_batch(tiny_params):
    from fdtd_tpu.sweep import batch_mesh

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION, dtype="float32")
    mesh = batch_mesh(8, devices=jax.devices("cpu"))
    import pytest

    with pytest.raises(ValueError, match="must divide"):
        frequency_sweep(p, [2.45e10] * 3, n_steps=4, mesh=mesh)


def test_material_sweep_sharded_matches_unsharded(tiny_params):
    from fdtd_tpu.sweep import batch_mesh

    p = dataclasses.replace(tiny_params, dtype="float32")
    mats = [
        water_block(p, lo=(0.1, 0.1, 0.1), hi=(0.5, 0.5, 0.5), eps_r=1.0, sigma=s)
        for s in (0.25, 0.5, 1.0, 2.0)
    ]
    want = material_sweep(p, mats, n_steps=8)
    mesh = batch_mesh(4, devices=jax.devices("cpu"))
    got = material_sweep(p, mats, n_steps=8, mesh=mesh)
    assert len(got.states.ez.sharding.device_set) == 4
    for c in ["ez", "hx", "ey"]:
        np.testing.assert_array_equal(
            np.asarray(getattr(got.states, c)), np.asarray(getattr(want.states, c)),
            err_msg=c,
        )


def test_material_sweep(tiny_params):
    p = dataclasses.replace(tiny_params, dtype="float32")
    mats = [
        water_block(p, lo=(0.1, 0.1, 0.1), hi=(0.5, 0.5, 0.5), eps_r=1.0, sigma=s)
        for s in (0.5, 2.0, 8.0)
    ]
    res = material_sweep(p, mats, n_steps=15)
    e = np.asarray(res.e_energy) + np.asarray(res.h_energy)
    # more conductive load -> more dissipation
    assert e[0] > e[1] > e[2] > 0


def test_frequency_sweep_spatial_mesh_matches_serial(tiny_params):
    """Sweep x spatial sharding (VERDICT r2 weak #6): a (2, 4) ("b", "z")
    mesh — members over b, each member's grid over z — matches the
    unsharded sweep bit-for-bit."""
    from fdtd_tpu.params import Mode
    from fdtd_tpu.sweep import spatial_batch_mesh

    p = dataclasses.replace(tiny_params, dtype="float32", mode=Mode.COMPUTATION)
    freqs = [2.45e10, 1.9e10]
    want = frequency_sweep(p, freqs, n_steps=8)
    mesh = spatial_batch_mesh(2, 4, devices=jax.devices("cpu"))
    got = frequency_sweep(p, freqs, n_steps=8, mesh=mesh)
    assert len(got.states.ez.sharding.device_set) == 8
    for c in ["ez", "hx", "ey"]:
        # partitioned fusion reassociates FMAs: 1-ulp tolerance
        np.testing.assert_allclose(
            np.asarray(getattr(got.states, c)), np.asarray(getattr(want.states, c)),
            atol=1e-6, rtol=0, err_msg=c,
        )
    np.testing.assert_allclose(
        np.asarray(got.e_energy), np.asarray(want.e_energy), rtol=1e-6
    )


def test_material_sweep_spatial_mesh_matches_serial(tiny_params):
    from fdtd_tpu.sweep import spatial_batch_mesh

    p = dataclasses.replace(tiny_params, dtype="float32")
    mats = [
        water_block(p, lo=(0.1, 0.1, 0.1), hi=(0.5, 0.5, 0.5), eps_r=1.0, sigma=s)
        for s in (0.5, 2.0)
    ]
    want = material_sweep(p, mats, n_steps=8)
    mesh = spatial_batch_mesh(2, 2, devices=jax.devices("cpu"))
    got = material_sweep(p, mats, n_steps=8, mesh=mesh)
    assert len(got.states.ez.sharding.device_set) == 4
    for c in ["ez", "hx", "ey"]:
        np.testing.assert_allclose(
            np.asarray(getattr(got.states, c)), np.asarray(getattr(want.states, c)),
            atol=1e-6, rtol=0, err_msg=c,
        )


def test_frequency_sweep_pml_matches_individual_run(tiny_params):
    """Open-boundary sweeps (r3): each vmapped member carries its own
    CPML psi through the scan == a standalone PML run at that frequency.
    Uses a gaussian envelope so the sweep's drive construction is pinned
    to go through drive_values (a bare sin grid would silently drop the
    burst)."""
    import pytest

    from fdtd_tpu.ops.cpml import PMLConfig, init_psi, make_pml_chunk_runner
    from fdtd_tpu.params import SourceConfig

    p = dataclasses.replace(
        tiny_params, mode=Mode.COMPUTATION, dtype="float32",
        source=SourceConfig(envelope="gaussian"),
    )
    cfg = PMLConfig(cells=3)
    freqs = [2.45e10, 1.0e10]
    res = frequency_sweep(p, freqs, n_steps=10, pml=cfg)
    assert res.states.ex.shape[0] == 2

    p1 = dataclasses.replace(
        p, source=SourceConfig(frequency=freqs[1], envelope="gaussian"))
    run = make_pml_chunk_runner(p1, cfg)
    xs = scan_inputs(p1, time_values(p1)[:10])
    (want, _), _ = run((zeros(p1), init_psi(p1, cfg)), xs, None)
    for c in ["ez", "hx", "ey"]:
        np.testing.assert_allclose(
            np.asarray(getattr(res.states, c))[1],
            np.asarray(getattr(want, c)), atol=1e-7, rtol=1e-5, err_msg=c,
        )


def test_material_sweep_pml_matches_individual_run(tiny_params):
    from fdtd_tpu.ops.cpml import PMLConfig, init_psi, make_pml_chunk_runner

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION, dtype="float32")
    cfg = PMLConfig(cells=3)
    mats = [
        water_block(p, lo=(0.3, 0.3, 0.3), hi=(0.7, 0.7, 0.7)),
        water_block(p, lo=(0.4, 0.4, 0.4), hi=(0.8, 0.8, 0.8)),
    ]
    res = material_sweep(p, mats, n_steps=10, pml=cfg)
    assert res.states.ex.shape[0] == 2

    run = make_pml_chunk_runner(p, cfg, mats[0])
    xs = scan_inputs(p, time_values(p)[:10])
    (want, _), _ = run((zeros(p), init_psi(p, cfg)), xs, None)
    for c in ["ez", "hx", "ey"]:
        np.testing.assert_allclose(
            np.asarray(getattr(res.states, c))[0],
            np.asarray(getattr(want, c)), atol=1e-7, rtol=1e-5, err_msg=c,
        )
