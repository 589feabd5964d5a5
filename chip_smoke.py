#!/usr/bin/env python
"""Smoke test of the solver on one NVIDIA GPU: the quickest proof that the
system still starts on the card and computes the right fields.

    python chip_smoke.py               # one card, phases 1-4
    python chip_smoke.py --four-gpus   # four cards: phase 5 only

Phases (each a function the CPU tests call at a tiny size):

1. the reference's headline through the CLI — 250^3 validation mode,
   1000 steps, fp32, snapshots and the native writer — held to the
   reference's e_r(Ey) <= 0.73 % and energy error <= 0.2 % (BASELINE.md)
   at every snapshot step, each field compared at its own time;
2. parity: fp32 on the GPU against fp64 on the CPU, relative L2 <= 1e-5;
3. every composition the bench times, GPU against the same run on the CPU;
4. headline timing at 256^3, fp32 and bf16, against a plain device copy;
5. (``--four-gpus``) ``--shard 4`` and ``--shard 2x2`` at 512^3 against one
   card.

One process holds the card.  Any failed phase raises, and the script exits
nonzero; without a GPU it exits nonzero before printing any result.  The
last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from fdtd_tpu.utils.device import NoGpuError, gpu_identity, require_gpus  # noqa: E402

# the data sheet's HBM rate of one H100 SXM (the stencil is memory-bound)
H100_HBM_BYTES_PER_S = 3.35e12
# the step's computed floor (docs/DESIGN.md): six fields read and written
FLOOR_BYTES_PER_CELL = {"float32": 48, "bfloat16": 24}

# Tolerances of GPU-against-CPU runs of the same dtype, at phase 3's sizes
# (64^3 x 100 steps here, 24^3 x 50 in the gpu tests).  The stencil has no
# matrix products, so TF32 never applies; the two backends still differ in
# the last bits through FMA contraction and fusion order.  fp32 holds the
# repo's 1e-5 north-star bar.  bf16 is held to the same 1e-5: at these
# sizes XLA's GPU and CPU programs round the bf16 step alike (readings on
# an H100 at most 3.4e-8, from the DFT's fp32 sums), while one bf16 ulp
# added in a band of 1/16 of the cells reads >= 2e-3, a control phase 3
# runs beside each bf16 comparison.  The limit does not carry to larger
# grids: at 128^3 x 200 the two backends round differently and read ~5e-3
# (PERF.md).
TOLERANCE = {"float32": 1e-5, "bfloat16": 1e-5}

# the reference's own bars (BASELINE.md, description.pdf section 3)
E_R_EY_BAR = 0.0073
ENERGY_BAR = 0.002

_IDENTITY = [""]


def report(phase: str, **numbers) -> None:
    """One result line, printed beside the card's name and power limit."""
    print(f"{phase}: {json.dumps(numbers)} @ {_IDENTITY[0]}", flush=True)


def _box(n: int, steps: int, mode: int, dtype: str, dt: float = 1e-12,
         dx: float = 0.001, sampling_rate: int = 10**9):
    from fdtd_tpu.params import Mode, Params

    return Params(
        length=n * dx, width=n * dx, height=n * dx, spatial_step=dx,
        time_step=dt, simulation_time=(steps - 0.5) * dt,
        sampling_rate=sampling_rate, mode=Mode(mode), dtype=dtype,
    )


def _rel_l2(got, want) -> float:
    """sqrt(sum (got - want)^2 / sum want^2) over a tuple of arrays, fp64."""
    num = den = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        num += float(np.sum((g - w) ** 2))
        den += float(np.sum(w * w))
    return math.sqrt(num / den) if den > 0 else math.sqrt(num)


def _fields(state):
    return tuple(getattr(state, c) for c in ("ex", "ey", "ez", "hx", "hy", "hz"))


# -- phase 1 --------------------------------------------------------------

def _energy_errors(p, rec) -> tuple[float, float]:
    """(counter, own-time) energy error of one energy-log record: the
    logged E + H energy against eps0*a*b*d/8 (the reference's metric), and
    against the analytic mode's E and H energies at the fields' own times
    (``analytic.field_times``; the initial record holds E at 0, H = 0)."""
    from fdtd_tpu import analytic, diagnostics

    w0 = diagnostics.theoretical_te101_energy(p)
    omega = 2 * math.pi * analytic.mode_constants(p)[0]
    t = rec["t"]
    times = (analytic.field_times(p, t) if rec["iteration"] > 0
             else {"ey": 0.0, "hx": 0.0})
    want = w0 * (math.cos(omega * times["ey"]) ** 2
                 + math.sin(omega * times["hx"]) ** 2)
    return abs(rec["total"] - w0) / w0, abs(rec["total"] - want) / w0


def phase_headline_cli(out_dir: str, n: int = 250, steps: int = 1000,
                       sampling_rate: int = 250, dx: float = 0.001,
                       dt: float = 1e-12) -> dict:
    """The reference's headline run through ``fdtd_tpu.cli.main``.

    Validation mode (the analytic TE101 mode), fp32, snapshots every
    ``sampling_rate`` steps into ``out_dir`` (device->host transfer, the
    .vtr writer, the native writer's build), and the energy log and a
    checkpoint at the same steps.  The report's dt = 1e-11 s breaks the
    CFL limit dx/(c sqrt 3) ~ 1.9e-12 s at dx = 1 mm; the default 1e-12 s
    is the largest round step under it.

    Each checkpoint is held to e_r(Ey) <= 0.73 % and each energy record to
    an energy error <= 0.2 %, the reference's bars, with every field
    compared with the analytic mode at its own time
    (``analytic.field_times``).  The reference's convention compares E
    and H at the time counter instead, where the leapfrog fields do not
    sit: that adds an O(omega dt) term which does not shrink with the grid
    and swings with |tan(omega t)| (~1.1 % of e_r(Ey) at t ~ 1 ns, up to
    0.27 % of the energy at dt = 1e-12 s).  Those readings are reported
    beside the gated ones, not held to the bars."""
    from fdtd_tpu import analytic, cli
    from fdtd_tpu.io.checkpoint import load_checkpoint
    from fdtd_tpu.params import load_parameters

    os.makedirs(out_dir, exist_ok=True)
    params = os.path.join(out_dir, "params.txt")
    side = n * dx
    with open(params, "w") as f:
        f.write(f"{side!r} {side!r} {side!r} {dx!r} {dt!r} "
                f"{(steps - 0.5) * dt!r} {sampling_rate} 0\n")
    diag = os.path.join(out_dir, "energy.jsonl")
    if os.path.exists(diag):
        os.remove(diag)
    for old in glob.glob(os.path.join(out_dir, "*.vtr")) + glob.glob(
            os.path.join(out_dir, "ckpt*.npz")):
        os.remove(old)
    t0 = time.perf_counter()
    rc = cli.main([params, "--out", out_dir, "--diag-log", diag,
                   "--checkpoint-every", str(sampling_rate)])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"fdtd_tpu.cli exited {rc}")
    p = load_parameters(params, dtype="float32")
    ckpts = sorted(glob.glob(os.path.join(out_dir, "ckpt[0-9]*.npz")))
    ends = []
    for path in ckpts:
        state, it, t, _ = load_checkpoint(path, p)
        os.remove(path)
        own = analytic.own_time_error(p, state, t)
        ends.append({"step": it, "t_s": t, "e_r_ey": own["ey"],
                     "e_r_hx": own["hx"], "e_r_hz": own["hz"],
                     "e_r_ey_at_counter":
                         analytic.relative_l2_error(p, state, t)["ey"]})
    if [e["step"] for e in ends] != list(
            range(sampling_rate, steps + 1, sampling_rate)):
        raise RuntimeError(f"checkpoints at {[e['step'] for e in ends]}")
    with open(diag) as f:
        energy = [_energy_errors(p, json.loads(line)) for line in f]
    snaps = sorted(os.path.basename(s)
                   for s in glob.glob(os.path.join(out_dir, "result*.vtr")))
    e_r_max = max(e["e_r_ey"] for e in ends)
    w_max = max(own for _, own in energy)
    out = {"grid": [p.maxk, p.maxj, p.maxi], "steps": steps, "dt_s": dt,
           "e_r_ey_max": e_r_max, "energy_error_max": w_max,
           "end_times": ends,
           "energy_errors_own_time": [own for _, own in energy],
           "energy_errors_at_counter": [ctr for ctr, _ in energy],
           "snapshots": snaps, "cli_wall_s": wall}
    report("phase1_headline_cli", **out)
    if not e_r_max <= E_R_EY_BAR:
        raise AssertionError(f"e_r(Ey) {e_r_max:.3e} > {E_R_EY_BAR}")
    if not w_max <= ENERGY_BAR:
        raise AssertionError(f"energy error {w_max:.3e} > {ENERGY_BAR}")
    if len(snaps) < 2:
        raise AssertionError(f"expected snapshots, found {snaps}")
    return out


# -- phase 2 --------------------------------------------------------------

def phase_parity(dev, ref_dev, n: int = 64, steps: int = 200) -> dict:
    """Computation mode, fp32 on ``dev`` against fp64 on ``ref_dev``."""
    import jax

    from fdtd_tpu.runner import run_simulation

    quiet = lambda s: None
    with jax.default_device(dev):
        got = run_simulation(_box(n, steps, 1, "float32"),
                             write_snapshots=False, log=quiet)
        got_f = [np.asarray(a) for a in _fields(got.state)]
    with jax.enable_x64(True), jax.default_device(ref_dev):
        want = run_simulation(_box(n, steps, 1, "float64"),
                              write_snapshots=False, log=quiet)
        want_f = [np.asarray(a) for a in _fields(want.state)]
    if want_f[0].dtype != np.float64:
        raise AssertionError("the fp64 reference did not run in fp64")
    l2 = _rel_l2(got_f, want_f)
    out = {"grid": n, "steps": steps, "rel_l2_fp32_vs_fp64": l2,
           "device": str(dev.device_kind), "reference": str(ref_dev)}
    report("phase2_parity", **out)
    if not l2 <= 1e-5:
        raise AssertionError(f"fp32 vs fp64 relative L2 {l2:.3e} > 1e-5")
    return out


# -- phase 3 --------------------------------------------------------------

# Phase 3's compositions: (bench.py scene, dtype) for each composed row the
# bench times, built by the bench's own scene table.
COMPOSITIONS = {
    "water_sar": ("heating_sar", "float32"),
    "pml10": ("pml", "float32"),
    "dft": ("dft", "float32"),
    "pml_dft": ("pml_dft", "float32"),
    "dispersive_sar": ("dispersive_sar", "float32"),
    "dispersive_dft": ("dispersive_dft", "float32"),
    "bf16": ("vacuum", "bfloat16"),
}


def composition_kwargs(name: str, p) -> tuple:
    """(params, run_simulation kwargs) for one composition: the flags a
    user passes, as ``bench.scene`` builds them."""
    import bench

    kind, dtype = COMPOSITIONS[name]
    p = dataclasses.replace(p, dtype=dtype)
    return p, bench.scene(kind, p)


def _outputs(res) -> tuple:
    arrays = [np.asarray(a) for a in _fields(res.state)]
    if res.power_j is not None:
        arrays.append(np.asarray(res.power_j))
    if res.dft is not None:
        arrays += [res.dft.phasors.real, res.dft.phasors.imag]
    return tuple(arrays)


def one_ulp_band(arrays) -> tuple:
    """The control fault: every nonzero bf16 value in a band of 1/16 of the
    minor axis moved one ulp away from zero; other arrays unchanged."""
    out = []
    for a in arrays:
        a = np.array(a)
        if a.dtype.itemsize == 2:
            bits = a.view(np.uint16)
            w = max(1, a.shape[-1] // 32)
            band = np.zeros(a.shape, bool)
            band[..., a.shape[-1] // 2 - w:a.shape[-1] // 2 + w] = True
            bits += (band & ((bits & 0x7FFF) != 0)).astype(np.uint16)
        out.append(a)
    return tuple(out)


def phase_compositions(dev, ref_dev, n: int = 64, steps: int = 100,
                       names=COMPOSITIONS) -> dict:
    """Each composition on ``dev`` against the same run on ``ref_dev``; a
    bf16 run also checks that its limit catches :func:`one_ulp_band`."""
    import jax

    from fdtd_tpu.runner import run_simulation

    out = {}
    for name in names:
        p, kw = composition_kwargs(name, _box(n, steps, 1, "float32"))
        runs = []
        for d in (dev, ref_dev):
            with jax.default_device(d):
                res = run_simulation(p, write_snapshots=False,
                                     log=lambda s: None, **kw)
                runs.append(_outputs(res))
        l2 = _rel_l2(*runs)
        finite = all(np.all(np.isfinite(a)) for a in runs[0])
        tol = TOLERANCE[p.dtype]
        out[name] = {"dtype": p.dtype, "rel_l2": l2, "tol": tol,
                     "finite": bool(finite)}
        if p.dtype == "bfloat16":
            out[name]["control_one_ulp_band"] = _rel_l2(
                one_ulp_band(runs[0]), runs[1])
        report(f"phase3_{name}", grid=n, steps=steps, **out[name])
        if not (finite and l2 <= tol):
            raise AssertionError(f"{name}: rel L2 {l2:.3e} (tol {tol}), "
                                 f"finite={finite}")
        if not out[name].get("control_one_ulp_band", math.inf) > tol:
            raise AssertionError(f"{name}: the limit {tol} passes a one-ulp "
                                 "fault in a band of cells")
    return out


# -- phase 4 --------------------------------------------------------------

def _device_seconds(fn, args, dev, reps: int = 5):
    """(seconds per call, clock): the summed durations of the kernels
    ``reps`` calls put on the GPU, from a profiler trace ("device"); on a
    host device, which the trace does not show as a GPU, the best wall time
    of a call ("wall")."""
    import shutil
    import tempfile

    import jax
    from jax.profiler import ProfileData

    if dev.platform == "gpu":
        tmp = tempfile.mkdtemp(prefix="smoke_trace_")
        try:
            jax.profiler.start_trace(tmp)
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
            jax.profiler.stop_trace()
            (path,) = glob.glob(f"{tmp}/**/*.xplane.pb", recursive=True)
            ns = sum(ev.duration_ns
                     for plane in ProfileData.from_file(path).planes
                     if f"GPU:{dev.id}" in plane.name
                     for line in plane.lines if "Compute" in line.name
                     for ev in line.events)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if ns <= 0:
            raise RuntimeError("the trace shows no kernel on the GPU")
        return ns * 1e-9 / reps, "device"
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return min(walls), "wall"


def _cost_bytes(compiled) -> float:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("bytes accessed", float("nan")))


def time_headline(dev, n: int = 256, steps: int = 1000, dtype="float32",
                  reps: int = 3) -> dict:
    """The runner's chunk path over ``steps`` steps at n^3, computation
    mode, after a warm-up at the same shapes; the single step's compiled
    bytes; and a plain device copy of the same six fields."""
    import jax
    import jax.numpy as jnp

    from fdtd_tpu.params import time_values
    from fdtd_tpu.runner import build_chunk_runner
    from fdtd_tpu.state import zeros
    from fdtd_tpu.step import make_step, scan_inputs

    p = _box(n, steps, 1, dtype)
    with jax.default_device(dev):
        runner = build_chunk_runner(p)
        xs = scan_inputs(p, time_values(p))
        state = jax.block_until_ready(runner.prep(zeros(p)))
        t0 = time.perf_counter()
        compiled = runner.run_chunk.lower(state, xs, None).compile()
        compile_s = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        jax.block_until_ready(compiled(state, xs, None))  # warm-up
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(state, xs, None))
            walls.append(time.perf_counter() - t0)
        wall = min(walls)

        step = jax.jit(make_step(p))
        x0 = (jnp.asarray(xs[0][0]), jnp.asarray(xs[1][0]))
        step_bytes = _cost_bytes(step.lower(state, x0).compile())

        # plain copies of the six fields: one pass reads and writes every
        # field once (the scale by a runtime one keeps XLA from eliding
        # it), timed on the device's own clock.  As stored, the fields are
        # n+1 wide; padded along i to a multiple of 8 they are the extent
        # XLA's GPU loops vectorize, and that copy is the yardstick
        one = jnp.asarray(1, state.ex.dtype)
        copy = jax.jit(lambda s, c: jax.tree.map(lambda a: a * c, s))
        pad = ((0, 0), (0, 0), (0, -state.ex.shape[-1] % 8))
        aligned = jax.tree.map(lambda a: jnp.pad(a, pad), state)
        bws = []
        for fields in (state, aligned):
            jax.block_until_ready(copy(fields, one))
            seconds, copy_clock = _device_seconds(copy, (fields, one), dev)
            nbytes = sum(a.size * a.dtype.itemsize for a in _fields(fields))
            bws.append(2 * nbytes / seconds)
        stored_bw, copy_bw = bws
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    step_bw = step_bytes * steps / wall
    floor_bw = FLOOR_BYTES_PER_CELL[dtype] * p.cell_count * steps / wall
    return {
        "grid": n, "steps": steps, "dtype": dtype,
        "mcells_per_s": p.cell_count * steps / wall / 1e6,
        "wall_s": wall, "walls_s": walls, "compile_s": compile_s,
        # XLA's own count: every fusion's operands and results, so a
        # slice that re-reads a plane from cache counts again
        "xla_bytes_per_cell_step": step_bytes / p.cell_count,
        "xla_bytes_per_s": step_bw,
        "xla_share_of_3.35TB/s": step_bw / H100_HBM_BYTES_PER_S,
        "xla_share_of_copy": step_bw / copy_bw,
        # the computed floor: each of the six fields read and written once
        "floor_bytes_per_s": floor_bw,
        "floor_share_of_3.35TB/s": floor_bw / H100_HBM_BYTES_PER_S,
        "floor_share_of_copy": floor_bw / copy_bw,
        "copy_bytes_per_s": copy_bw, "copy_clock": copy_clock,
        "copy_share_of_3.35TB/s": copy_bw / H100_HBM_BYTES_PER_S,
        "copy_stored_layout_bytes_per_s": stored_bw,
        "peak_bytes_in_use": peak,
        "memory_analysis": str(mem),
    }


def phase_timing(dev, n: int = 256, steps: int = 1000, reps: int = 3) -> dict:
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = time_headline(dev, n, steps, dtype, reps)
        report(f"phase4_timing_{dtype}", **out[dtype])
    return out


# -- phase 5 --------------------------------------------------------------

def phase_four_gpus(devs, n: int = 512, steps: int = 200,
                    specs=("4", "2x2"), reps: int = 3) -> dict:
    """``--shard`` over four devices against one device, validation mode
    (the TE101 mode fills every shard, so each halo carries data).  The
    fields come from ``run_simulation``; the wall time is the same
    dispatch's chunk over all ``steps``, after a warm-up call at the same
    shapes (so no compilation is timed), best of ``reps``."""
    import jax

    from fdtd_tpu.params import time_values
    from fdtd_tpu.runner import build_chunk_runner, initial_state, run_simulation
    from fdtd_tpu.step import scan_inputs

    if len(devs) < 4:
        raise NoGpuError(f"--four-gpus needs 4 devices; found {len(devs)}")
    p = _box(n, steps, 0, "float32")
    xs = scan_inputs(p, time_values(p))

    def run(shard):
        res = run_simulation(p, write_snapshots=False, shard=shard,
                             log=lambda s: None)
        fields = [np.asarray(a) for a in _fields(res.state)]
        runner = build_chunk_runner(p, shard=shard)
        carry = jax.block_until_ready(runner.prep(initial_state(p)))
        jax.block_until_ready(runner.run_chunk(carry, xs, None))  # warm-up
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(runner.run_chunk(carry, xs, None))
            walls.append(time.perf_counter() - t0)
        return fields, {"wall_s": min(walls), "walls_s": walls,
                        "mcells_per_s": p.cell_count * steps / min(walls) / 1e6}

    with jax.default_device(devs[0]):
        want, one = run(None)
    out = {"one_device": one}
    report("phase5_one_device", grid=n, steps=steps, **one)
    for spec in specs:
        got, timing = run(spec)
        l2 = _rel_l2(got, want)
        exact = all(np.array_equal(g, w) for g, w in zip(got, want))
        out[spec] = {"rel_l2": l2, "bit_exact": bool(exact), **timing,
                     "speedup_vs_one_device": one["wall_s"] / timing["wall_s"]}
        report(f"phase5_shard_{spec}", grid=n, steps=steps, **out[spec])
        if not l2 <= TOLERANCE["float32"]:
            raise AssertionError(f"--shard {spec}: rel L2 {l2:.3e}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card --shard phase")
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for phase 1's snapshots")
    args = ap.parse_args(argv)
    try:
        devs = require_gpus(4 if args.four_gpus else 1)
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    import jax

    from fdtd_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    identity = gpu_identity()
    _IDENTITY[0] = " | ".join(identity.splitlines())
    print(f"device_kind={devs[0].device_kind} devices={len(devs)} "
          f"platform={devs[0].platform}")
    print(identity, flush=True)
    if args.four_gpus:
        phase_four_gpus(devs[:4])
        count = 4
    else:
        cpu = jax.devices("cpu")[0]
        phase_headline_cli(args.out)
        phase_parity(devs[0], cpu)
        phase_compositions(devs[0], cpu)
        phase_timing(devs[0])
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
