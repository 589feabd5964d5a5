#!/usr/bin/env python
"""Yee cell-updates/s for each composed path, timed on the GPU.

    python bench.py                    # every row, one JSON line per row
    python bench.py --row NAME [N [STEPS]]

Every row builds its chunk runner through ``fdtd_tpu.runner.
build_chunk_runner`` — the dispatch ``run_simulation`` uses for the same
flags — and times whole chunks ended by ``jax.block_until_ready``, after a
warm-up call at the same shapes.  Each row runs in its own subprocess, one
after another, so each has the card to itself; the parent never touches a
JAX backend.  Each row records the device as JAX reports it and the card's
name and power limit from ``nvidia-smi``.  A row that finds no GPU fails,
and the bench exits nonzero if any row failed.

Baseline: the reference's single-core 74 Mcells/s (BASELINE.md: 250^3 x
1000 steps in 211 s on an EPYC 7542 core, no I/O).  No output is written in
the timed region.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MCELLS = 74.0


def _params(n, steps, dtype):
    from fdtd_tpu.params import Mode, Params

    dx = 0.001
    return Params(
        length=n * dx, width=n * dx, height=n * dx, spatial_step=dx,
        time_step=1e-12, simulation_time=(steps - 0.5) * 1e-12,
        sampling_rate=10**9, mode=Mode.COMPUTATION, dtype=dtype,
    )


def scene(kind, p):
    """run_simulation keyword arguments for one row's flags."""
    from fdtd_tpu.dft import DftConfig
    from fdtd_tpu.ops.cpml import PMLConfig
    from fdtd_tpu.ops.dispersive import water_debye_load
    from fdtd_tpu.state import water_block

    pml = PMLConfig(cells=min(10, min(p.maxk, p.maxj, p.maxi) // 2 - 1))
    dft = DftConfig((2.45e10,))
    return {
        "vacuum": {},
        "heating_sar": dict(materials=water_block(p), accumulate_power=True),
        "pml": dict(pml=pml),
        "dft": dict(dft=dft),
        "dispersive_sar": dict(materials=water_debye_load(p, sigma_ion25=0.3),
                               accumulate_power=True),
        "dispersive_dft": dict(materials=water_debye_load(p, sigma_ion25=0.3),
                               dft=dft),
        "pml_dft": dict(pml=pml, dft=dft),
    }[kind]


# name -> (scene, dtype, grid multiple of n)
ROWS = {
    "headline": ("vacuum", "float32", 1),
    "aux_bfloat16": ("vacuum", "bfloat16", 1),
    "heating_sar_bf16": ("heating_sar", "bfloat16", 1),
    "heating_sar_fp32": ("heating_sar", "float32", 1),
    "pml10_fp32": ("pml", "float32", 1),
    "pml10_bf16": ("pml", "bfloat16", 1),
    "dft_fp32": ("dft", "float32", 1),
    "dispersive_sar_bf16": ("dispersive_sar", "bfloat16", 1),
    "dispersive_sar_fp32": ("dispersive_sar", "float32", 1),
    "dispersive_dft_fp32": ("dispersive_dft", "float32", 1),
    "pml_dft_fp32": ("pml_dft", "float32", 1),
    "grid512_fp32": ("vacuum", "float32", 2),
}


def time_row(name, n=256, steps=1000, reps=3):
    """Time one row on the default device; returns its result dict."""
    import jax
    import numpy as np

    from fdtd_tpu.dft import dft_weights
    from fdtd_tpu.params import time_values
    from fdtd_tpu.runner import build_chunk_runner, initial_state
    from fdtd_tpu.step import scan_inputs, zero_power_acc
    from fdtd_tpu.utils.device import device_record

    kind, dtype, scale = ROWS[name]
    p = _params(scale * n, steps, dtype)
    kw = scene(kind, p)
    runner = build_chunk_runner(p, **kw)
    ts = time_values(p)
    chunk = scan_inputs(p, ts)
    if "dft" in kw:
        chunk = chunk + dft_weights(kw["dft"], ts)
    sar = kw.get("accumulate_power", False)
    carry0 = jax.block_until_ready(runner.prep(initial_state(p)))

    def once():
        power = zero_power_acc(p) if sar else None
        t0 = time.perf_counter()
        out = runner.run_chunk(carry0, chunk, power)
        jax.block_until_ready((out, runner.dft_box["acc"]))
        return time.perf_counter() - t0, out

    first_s, out = once()  # compile + warm-up at the timed shapes
    walls = [once()[0] for _ in range(reps)]
    wall = min(walls)
    fields = runner.restore(out[0])
    finite = bool(np.isfinite(np.asarray(fields.ez, np.float32)).all())
    mcells = p.cell_count * len(ts) / wall / 1e6
    return {
        "row": name, "metric": f"yee_mcells_per_s_{p.maxi}cubed",
        "value": mcells, "unit": "Mcells/s",
        "vs_baseline": mcells / BASELINE_MCELLS,
        "wall_s_per_1k_steps": wall * 1000 / len(ts), "walls_s": walls,
        "first_call_s": first_s, "dtype": dtype, "steps": len(ts),
        "grid": p.maxi, "finite": finite, **device_record(),
    }


def run_row(name, n, steps):
    """Row subprocess: the GPU gate, then the timing."""
    from fdtd_tpu.compile_cache import enable_compile_cache
    from fdtd_tpu.utils.device import gpu_identity, require_gpus

    require_gpus()
    enable_compile_cache()
    res = time_row(name, n, steps)
    res["nvidia_smi"] = gpu_identity()
    return res


def run_all_rows(n=256, steps=1000):
    """Every row in its own subprocess, in turn; returns (results, ok)."""
    results, ok = [], True
    for name in ROWS:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--row", name,
             str(n), str(steps)],
            capture_output=True, text=True, timeout=900,
        )
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode == 0 and last.startswith("{"):
            res = json.loads(last)
        else:
            ok = False
            res = {"row": name, "error": (proc.stderr or proc.stdout
                                          ).strip()[-400:]}
        print(json.dumps(res), flush=True)
        results.append(res)
    return results, ok


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--row":
        n_r = int(sys.argv[3]) if len(sys.argv) > 3 else 256
        steps_r = int(sys.argv[4]) if len(sys.argv) > 4 else 1000
        print(json.dumps(run_row(sys.argv[2], n_r, steps_r)))
        sys.exit(0)
    _, all_ok = run_all_rows(n=int(os.environ.get("FDTD_BENCH_N", "256")),
                             steps=int(os.environ.get("FDTD_BENCH_STEPS",
                                                      "1000")))
    sys.exit(0 if all_ok else 1)
