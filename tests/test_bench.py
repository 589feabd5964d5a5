"""bench.py: each row at a tiny size on the CPU (the rows' dispatch and
bookkeeping), and its refusal to time anything but a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


@pytest.mark.parametrize("name", list(bench.ROWS))
def test_bench_row_tiny(name):
    res = bench.time_row(name, n=8, steps=4, reps=1)
    assert res["row"] == name and res["finite"]
    assert res["value"] > 0 and res["steps"] == 4
    assert res["grid"] == 8 * bench.ROWS[name][2]
    assert res["dtype"] == bench.ROWS[name][1]
    assert res["platform"] == "cpu" and res["count"] >= 1 and res["kind"]


def test_bench_row_refuses_cpu():
    from fdtd_tpu.utils.device import NoGpuError

    with pytest.raises(NoGpuError, match="no GPU found"):
        bench.run_row("headline", 6, 4)


def test_bench_row_subprocess_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench.py"),
                           "--row", "headline", "6", "4"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
