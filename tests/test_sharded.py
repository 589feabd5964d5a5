"""Multi-device correctness on a virtual 8-device CPU mesh.

The sharded paths (explicit shard_map + ppermute halos, and GSPMD) must
reproduce the single-device evolution exactly — the same guarantee the
reference's MPI branch was argued to have via validation mode
(description.pdf section 5)."""

import dataclasses

import jax
import numpy as np
import pytest

from fdtd_tpu.params import Mode, time_values
from fdtd_tpu.parallel.gspmd import make_gspmd_chunk_runner
from fdtd_tpu.parallel.mesh import factor3, make_mesh, pad_state_for_mesh, unpad_state
from fdtd_tpu.parallel.sharded_step import make_sharded_monitored_chunk_runner
from fdtd_tpu.state import init_validation, zeros
from fdtd_tpu.step import make_chunk_runner, scan_inputs

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 8, reason="needs 8 virtual devices"
)


def _single_device_result(p, n_steps):
    s = init_validation(p) if p.mode == Mode.VALIDATION else zeros(p)
    run = make_chunk_runner(p)
    xs = scan_inputs(p, time_values(p)[:n_steps])
    s, _ = run(s, xs, None)
    return s


def _compare(p, got, want, atol=1e-14):
    got = unpad_state(p, got)
    for c in COMPONENTS:
        np.testing.assert_allclose(
            np.asarray(getattr(got, c)),
            np.asarray(getattr(want, c)),
            atol=atol,
            rtol=1e-10,
            err_msg=c,
        )


@pytest.mark.parametrize("mesh_shape", [(8, 1, 1), (2, 2, 2), (1, 4, 2)])
@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_shard_map_matches_single_device(tiny_params, mesh_shape, mode):
    p = dataclasses.replace(tiny_params, mode=mode)
    n_steps = 10
    want = _single_device_result(p, n_steps)

    mesh = make_mesh(8, mesh_shape, devices=jax.devices("cpu"))
    s0 = init_validation(p) if mode == Mode.VALIDATION else zeros(p)
    s0 = pad_state_for_mesh(p, s0, mesh)
    run = make_sharded_monitored_chunk_runner(p, mesh)
    xs = scan_inputs(p, time_values(p)[:n_steps])
    got, _, _, _ = run(s0, xs, None, None)
    _compare(p, got, want)


@pytest.mark.parametrize("mode", [Mode.VALIDATION, Mode.COMPUTATION])
def test_gspmd_matches_single_device(tiny_params, mode):
    p = dataclasses.replace(tiny_params, mode=mode)
    n_steps = 10
    want = _single_device_result(p, n_steps)

    mesh = make_mesh(8, (2, 2, 2), devices=jax.devices("cpu"))
    s0 = init_validation(p) if mode == Mode.VALIDATION else zeros(p)
    s0 = pad_state_for_mesh(p, s0, mesh)
    run = make_gspmd_chunk_runner(p, mesh)
    xs = scan_inputs(p, time_values(p)[:n_steps])
    got = run(s0, xs)
    _compare(p, got, want)


def test_factor3():
    assert factor3(8) == (2, 2, 2)
    assert factor3(4) == (2, 2, 1)
    assert sorted(factor3(6), reverse=True) == [3, 2, 1]
    assert factor3(1) == (1, 1, 1)


def test_dryrun_entrypoint():
    from fdtd_tpu.parallel.sharded_step import dryrun

    dryrun(8)


def test_dryrun_multichip_hermetic():
    """The driver-facing entrypoint must pass WITHOUT conftest's pre-set
    virtual-device flags — it spawns its own subprocess (VERDICT r1 #1)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")
    }
    code = (
        f"import sys; sys.path.insert(0, {repo!r})\n"
        "import __graft_entry__\n"
        "__graft_entry__.dryrun_multichip(8)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "MULTICHIP_DRYRUN_OK" in proc.stdout


@pytest.mark.parametrize("shape", [(2, 2, 2), (8, 1, 1)])
def test_sharded_step_lossy_matches_single_device(tiny_params, shape):
    """Materials through the jnp sharded path (3-D decomposition included)."""
    from fdtd_tpu.state import water_block

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
    mats = water_block(p, lo=(0.2, 0.2, 0.2), hi=(0.8, 0.8, 0.8))
    n_steps = 8

    s0 = zeros(p)
    run_ref = make_chunk_runner(p, materials=mats)
    xs = scan_inputs(p, time_values(p)[:n_steps])
    want, _ = run_ref(s0, xs, None)

    mesh = make_mesh(8, shape, devices=jax.devices("cpu"))
    sp = pad_state_for_mesh(p, s0, mesh)
    run = make_sharded_monitored_chunk_runner(p, mesh, materials=mats)
    got, _, _, _ = run(sp, xs, None, None)
    _compare(p, got, want)


def test_sharded_step_mu_matches_single_device(tiny_params):
    """Heterogeneous mu_r through the jnp sharded path."""
    import numpy as _np

    from fdtd_tpu.state import Materials

    p = dataclasses.replace(tiny_params, mode=Mode.VALIDATION)
    K, J, I = p.maxk, p.maxj, p.maxi
    mu = _np.ones((K, J, I))
    mu[2:6, 2:6, 2:6] = 4.0
    mats = Materials(mu_r=mu)
    n_steps = 8

    s0 = init_validation(p)
    run_ref = make_chunk_runner(p, materials=mats)
    xs = scan_inputs(p, time_values(p)[:n_steps])
    want, _ = run_ref(s0, xs, None)

    mesh = make_mesh(8, (2, 2, 2), devices=jax.devices("cpu"))
    sp = pad_state_for_mesh(p, s0, mesh)
    run = make_sharded_monitored_chunk_runner(p, mesh, materials=mats)
    got, _, _, _ = run(sp, xs, None, None)
    _compare(p, got, want)


def test_sharded_xla_sar_matches_single_chip(tiny_params):
    """--shard --backend xla --sar: the jnp shard_map path accumulates
    SAR with cell-centered means built from the same halo shifts the
    curls use — matching the single-chip xla accumulation (fp64,
    reassociation tolerance on the lossy masked-vs-sliced fields)."""
    from fdtd_tpu.parallel.mesh import field_sharding, padded_divisible_shape
    from fdtd_tpu.state import water_block
    from fdtd_tpu.step import zero_power_acc

    import jax.numpy as jnp

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
    mats = water_block(p, lo=(0.2, 0.2, 0.2), hi=(0.8, 0.8, 0.8))
    n_steps = 8
    s0 = zeros(p)
    xs = scan_inputs(p, time_values(p)[:n_steps])
    run_ref = make_chunk_runner(p, materials=mats, accumulate_power=True)
    want, pw_want = run_ref(s0, xs, zero_power_acc(p))

    K, J, I = p.maxk, p.maxj, p.maxi
    mesh = make_mesh(8, (2, 2, 2), devices=jax.devices("cpu"))
    Kp, Jp, Ip = padded_divisible_shape(p, mesh)
    acc0 = jax.device_put(
        jnp.pad(zero_power_acc(p), ((0, Kp - K), (0, Jp - J), (0, Ip - I))),
        field_sharding(mesh),
    )
    sp = pad_state_for_mesh(p, s0, mesh)
    run = make_sharded_monitored_chunk_runner(p, mesh, materials=mats,
                                              accumulate_power=True)
    got, acc, _, _ = run(sp, xs, acc0, None)
    _compare(p, got, want)
    np.testing.assert_allclose(np.asarray(acc[:K, :J, :I]),
                               np.asarray(pw_want), atol=1e-30, rtol=1e-9)
    assert float(np.asarray(pw_want).max()) > 0
