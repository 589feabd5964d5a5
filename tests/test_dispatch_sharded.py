"""--shard through the one dispatch: every accepted flag combination runs
the jnp shard_map step on two of the virtual devices; asking for more
devices than exist is an error, never a move to other devices."""

import pytest

from .dispatch_combos import combo_id, combos, run_combo


@pytest.mark.parametrize("combo", combos(sharded=True), ids=combo_id)
def test_dispatch_runs_every_sharded_combination(combo):
    run_combo(combo)


def test_runner_refuses_too_few_devices(tiny_params):
    import jax

    from fdtd_tpu.runner import run_simulation

    n = len(jax.devices()) * 2
    with pytest.raises(ValueError, match=f"needs {n} devices; "
                                         f"{n // 2} cpu device"):
        run_simulation(tiny_params, write_snapshots=False, shard=str(n),
                       log=lambda s: None)


def test_dispersive_runner_refuses_too_few_devices(tiny_params):
    import dataclasses

    import jax

    from fdtd_tpu.ops.dispersive import water_debye_load
    from fdtd_tpu.params import Mode
    from fdtd_tpu.runner import run_simulation

    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION,
                            dtype="float32")
    n = len(jax.devices()) + 1
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        run_simulation(p, write_snapshots=False, shard=f"{n}",
                       materials=water_debye_load(p), accumulate_power=True,
                       log=lambda s: None)


def test_make_mesh_refuses_too_few_devices():
    import jax

    from fdtd_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    with pytest.raises(ValueError, match=f"needs {2 * n} cpu devices; "
                                         f"{n} available"):
        make_mesh(2 * n)
    assert make_mesh(n).devices.size == n
