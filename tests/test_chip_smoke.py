"""chip_smoke.py: its device gate, and each phase at a tiny size on the
CPU (the "device" and the CPU reference are both host devices here).
The ``gpu``-marked tests run the GPU-against-CPU phases on a card."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _env_cpu():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_device_gate_refuses_cpu(capsys):
    assert cs.main([]) == 1
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert '"ok"' not in out.out


def test_script_without_gpu_exits_nonzero_and_prints_no_result():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          env=_env_cpu(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_script_alone_exits_nonzero(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env_cpu()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_headline_cli_holds_reference_bars(tmp_path):
    """The CLI phase on the 0.25 m box at 100^3 and dt = 1e-12 s:
    snapshots, the energy log and four checkpoints, each held to the
    reference's e_r and energy bars at the fields' own times; the
    time-counter readings are reported beside them."""
    out = cs.phase_headline_cli(str(tmp_path), n=100, steps=1000,
                                sampling_rate=250, dx=0.0025)
    assert out["grid"] == [100, 100, 100]
    assert [e["step"] for e in out["end_times"]] == [250, 500, 750, 1000]
    assert out["e_r_ey_max"] <= cs.E_R_EY_BAR
    assert out["energy_error_max"] <= cs.ENERGY_BAR
    assert len(out["energy_errors_at_counter"]) == 5
    # the counter convention carries the stagger term the gate removes
    assert all(e["e_r_ey_at_counter"] > e["e_r_ey"] for e in out["end_times"])
    assert out["snapshots"] == ["result0001.vtr", "result0250.vtr",
                                "result0500.vtr", "result0750.vtr",
                                "result1000.vtr"]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("ckpt")]


def test_phase_headline_cli_rejects_a_failed_bar(tmp_path):
    """On an 8^3 grid of the same box the discretization error alone
    exceeds the 0.73 % bar: the phase raises."""
    with pytest.raises(AssertionError, match="e_r"):
        cs.phase_headline_cli(str(tmp_path), n=8, steps=200,
                              sampling_rate=100, dx=0.03125)


def test_phase_parity_tiny():
    cpu = jax.devices("cpu")
    out = cs.phase_parity(cpu[0], cpu[1], n=12, steps=20)
    assert 0 < out["rel_l2_fp32_vs_fp64"] <= 1e-5


@pytest.mark.parametrize("name", cs.COMPOSITIONS)
def test_phase_compositions_tiny(name):
    cpu = jax.devices("cpu")
    out = cs.phase_compositions(cpu[0], cpu[1], n=12, steps=10,
                                names=(name,))
    assert out[name]["finite"]
    assert out[name]["rel_l2"] <= out[name]["tol"]
    assert out[name]["dtype"] == ("bfloat16" if name == "bf16"
                                  else "float32")


def test_phase_timing_tiny():
    out = cs.phase_timing(jax.devices("cpu")[0], n=10, steps=6, reps=1)
    for dtype in ("float32", "bfloat16"):
        r = out[dtype]
        assert r["mcells_per_s"] > 0 and r["compile_s"] > 0
        assert r["xla_bytes_per_cell_step"] > 0
        assert r["copy_bytes_per_s"] > 0 and r["floor_share_of_copy"] > 0


def test_phase_four_devices_tiny():
    out = cs.phase_four_gpus(jax.devices("cpu")[:4], n=12, steps=10)
    for spec in ("4", "2x2"):
        assert out[spec]["bit_exact"] and out[spec]["rel_l2"] == 0.0


def test_phase_four_devices_needs_four():
    with pytest.raises(cs.NoGpuError, match="4 devices"):
        cs.phase_four_gpus(jax.devices("cpu")[:2], n=12, steps=10)


def test_report_line_carries_identity(capsys):
    cs._IDENTITY[0] = "NVIDIA H100 80GB HBM3, 700.00 W"
    try:
        cs.report("phaseX", value=1.5)
    finally:
        cs._IDENTITY[0] = ""
    line = capsys.readouterr().out.strip()
    head, ident = line.split(" @ ")
    assert ident == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(head.split(": ", 1)[1]) == {"value": 1.5}


@pytest.mark.gpu
def test_gpu_fp32_matches_cpu_fp64(gpu_devices):
    cs.phase_parity(gpu_devices[0], jax.devices("cpu")[0], n=32, steps=100)


@pytest.mark.gpu
@pytest.mark.parametrize("name", cs.COMPOSITIONS)
def test_gpu_composition_matches_cpu(gpu_devices, name):
    cs.phase_compositions(gpu_devices[0], jax.devices("cpu")[0], n=24,
                          steps=50, names=(name,))
