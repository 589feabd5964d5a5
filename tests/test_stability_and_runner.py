"""Stability-map utility and runner-level backend parity."""

import dataclasses

import numpy as np

from fdtd_tpu.runner import run_simulation
from fdtd_tpu.utils.stability import stability_map


def test_stability_map_matches_cfl_prediction(tiny_params):
    p = dataclasses.replace(tiny_params, dtype="float32")
    limit = p.cfl_limit()  # ~1.92e-12 for dx=1mm
    pts = stability_map(p, [0.5 * limit, 0.95 * limit, 1.6 * limit, 3.0 * limit])
    for pt in pts:
        assert pt.stable_observed == pt.stable_predicted, vars(pt)


def test_runner_backend_parity(tiny_params, tmp_path):
    """The two accepted backend names are one path: run_simulation writes
    identical .vtr snapshots for "auto" and "xla"."""
    p = dataclasses.replace(tiny_params, dtype="float32", sampling_rate=10)
    run_simulation(p, out_dir=str(tmp_path / "a"))
    run_simulation(p, out_dir=str(tmp_path / "b"), backend="xla")
    from fdtd_tpu.io.vtr import read_vtr_cell_arrays

    a = read_vtr_cell_arrays(str(tmp_path / "a" / "result0020.vtr"))
    b = read_vtr_cell_arrays(str(tmp_path / "b" / "result0020.vtr"))
    for k in ["ex", "ey", "ez", "hx", "hy", "hz", "aEy", "aHx", "aHz"]:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_runner_detects_divergence(tiny_params, tmp_path):
    """An unstable dt must abort with a clear error at the next sample."""
    import pytest

    p = dataclasses.replace(
        tiny_params, dtype="float32", time_step=4e-12,
        simulation_time=4.8e-10, sampling_rate=20,  # ~120 unstable steps
    )
    with pytest.raises(RuntimeError, match="diverged"):
        run_simulation(
            p,
            out_dir=str(tmp_path / "r"),
            write_snapshots=False,
            diagnostics_log=str(tmp_path / "d.jsonl"),
        )


def test_params_rejects_nonpositive_dt(tiny_params):
    """dt <= 0 must be a clean error, not the reference's infinite loop."""
    import pytest

    for bad in (0.0, -1e-12):
        p = dataclasses.replace(tiny_params, time_step=bad)
        with pytest.raises(ValueError, match="positive"):
            p.validate()


def test_cli_rejects_out_of_range_temporal_steps(tmp_path, capsys):
    """--temporal-steps selected a kernel tier that no longer exists:
    argument parsing refuses the flag at any value."""
    import pytest

    from fdtd_tpu.cli import main

    params = tmp_path / "p.txt"
    params.write_text("0.01 0.01 0.01 0.001 1e-12 2e-11 5 0")
    for value in ("4", "9"):
        with pytest.raises(SystemExit) as exc:
            main([str(params), "--temporal-steps", value])
        assert exc.value.code == 2
    assert "--temporal-steps" in capsys.readouterr().err


def test_runner_sharded_matches_single_device(tiny_params, tmp_path):
    """--shard runs (1-D and 2-D meshes, via run_simulation) produce .vtr
    snapshots identical to the single-device run, with and without a
    water load; bad specs / too many devices give clean ValueErrors."""
    import pytest

    from fdtd_tpu.io.vtr import read_vtr_cell_arrays
    from fdtd_tpu.params import Mode
    from fdtd_tpu.state import water_block

    p = dataclasses.replace(
        tiny_params, dtype="float32", sampling_rate=10, mode=Mode.COMPUTATION
    )
    mats = water_block(p, lo=(0.2, 0.2, 0.2), hi=(0.8, 0.8, 0.8))
    for materials, tag in ((None, "vac"), (mats, "water")):
        run_simulation(p, out_dir=str(tmp_path / tag), materials=materials,
                       log=lambda s: None)
        a = read_vtr_cell_arrays(str(tmp_path / tag / "result0020.vtr"))
        for spec in ("4", "2x2"):
            sub = f"{tag}_{spec}"
            run_simulation(p, out_dir=str(tmp_path / sub), shard=spec,
                           materials=materials, log=lambda s: None)
            b = read_vtr_cell_arrays(str(tmp_path / sub / "result0020.vtr"))
            for k in ["ex", "ey", "ez", "hx", "hy", "hz"]:
                # the masked shard_map update and the slice-based one
                # contract multiply-adds differently on the CPU: the
                # test's documented 1-ulp FMA-reassociation tolerance
                np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0,
                                           err_msg=f"{sub}/{k}")

    with pytest.raises(ValueError, match="bad --shard"):
        run_simulation(p, out_dir=str(tmp_path / "x"), shard="4xx2")
    with pytest.raises(ValueError, match="devices"):
        run_simulation(p, out_dir=str(tmp_path / "x"), shard="64")
    with pytest.raises(ValueError, match="sar"):
        run_simulation(p, out_dir=str(tmp_path / "x"), shard="4",
                       accumulate_power=True)
