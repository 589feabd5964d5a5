"""Simulation orchestration: snapshot cadence, diagnostics, checkpoints.

Replicates the reference driver's observable behavior (reference:
propagate_fields, main.c:755-799): an initial snapshot at iteration 1
*before* the loop, then one snapshot after every step whose 1-based index is
a multiple of ``sampling_rate`` — with params.txt's rate=2 that yields files
0001, 0002, 0004, ... (SURVEY section 2.4 item 8).  Steps between snapshots
run as one jitted ``lax.scan`` chunk; snapshot encoding is asynchronous
(:mod:`fdtd_tpu.io.snapshots`).

Extensions over the reference: JSONL energy/diagnostic logging, optional
SAR/power-deposition accumulation, checkpoint/resume.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import diagnostics
from .io.checkpoint import CheckpointWriter, latest_checkpoint, load_checkpoint
from .io.snapshots import SnapshotWriter, aggregate_all, validation_extras
from .params import Mode, Params, time_values
from .state import FieldState, Materials, init_validation, zeros
from .step import make_chunk_runner, scan_inputs, zero_power_acc


@dataclasses.dataclass
class RunResult:
    state: FieldState
    iterations: int
    wall_seconds: float
    mcells_per_s: float
    power_j: jax.Array | None = None
    warnings: list[str] = dataclasses.field(default_factory=list)
    dft: object | None = None  # dft.DftResult when run with dft=DftConfig
    probes: object | None = None  # monitors.ProbeResult when probes given


def _monitor_boxes(p: Params, dft):
    """(dft_box, probe_chunks): the host-side monitor accumulators a
    monitored chunk runner threads across chunks."""
    from . import dft as dft_mod

    return (
        {"acc": dft_mod.zero_dft_acc(p, dft) if dft is not None else None},
        [],
    )


def _monitored_run_chunk(run_mon, dft_box, probe_chunks):
    """The one run_chunk wrapper every monitored path shares: thread the
    DFT accumulator through the box, collect probe rows per chunk."""

    def run_chunk(st, chunk, power):
        st, power, dft_box["acc"], ys = run_mon(
            st, chunk, power, dft_box["acc"]
        )
        if ys is not None:
            probe_chunks.append(np.asarray(ys))
        return st, power

    return run_chunk


def _dft_memory_note(p: Params, dft) -> str | None:
    """Warning text when the DFT accumulators (re+im fp32 pairs) cross
    2 GB of device memory — surfaced up front instead of as a mid-run
    OOM."""
    acc_gb = (dft.nf * dft.nc * p.maxk * p.maxj * p.maxi * 8) / 2**30
    if acc_gb <= 2.0:
        return None
    return (
        f"DFT accumulators need {acc_gb:.1f} GB of device memory "
        f"({dft.nf} frequencies x {dft.nc} components at "
        f"{p.maxk}x{p.maxj}x{p.maxi}); consider fewer frequencies "
        "or fields='e'"
    )


def initial_state(p: Params) -> FieldState:
    return init_validation(p) if p.mode == Mode.VALIDATION else zeros(p)


def parse_shard_spec(spec: str) -> tuple[int, int]:
    """'4' -> (4, 1) z-slabs; '4x2' -> (4, 2) z*y decomposition.

    The CLI analogue of the reference's ``mpirun -np N ./microwave``
    (description.pdf section 2.2): the grid shards over devices instead of
    ranks.  i-axis (third factor) sharding is API-only
    (``parallel.sharded_step``).
    """
    parts = str(spec).lower().split("x")
    try:
        dims_ = [int(x) for x in parts]
    except ValueError:
        raise ValueError(f"bad --shard spec {spec!r}: use e.g. 4 or 4x2")
    if not 1 <= len(dims_) <= 2 or any(d < 1 for d in dims_):
        raise ValueError(f"bad --shard spec {spec!r}: use e.g. 4 or 4x2")
    nz = dims_[0]
    ny = dims_[1] if len(dims_) > 1 else 1
    return nz, ny


def shard_mesh(shard: str):
    """The (nz, ny, 1) device mesh for a ``--shard`` spec, over the default
    backend's devices; too few of them is an error naming the count."""
    from .parallel.mesh import make_mesh

    nz, ny = parse_shard_spec(shard)
    n = nz * ny
    devs = jax.devices()
    if len(devs) < n:
        raise ValueError(
            f"--shard {shard} needs {n} devices; {len(devs)} "
            f"{devs[0].platform} device(s) available"
        )
    return make_mesh(n, (nz, ny, 1), devices=devs[:n])


@dataclasses.dataclass
class ChunkRunner:
    """What the one dispatch builds for a run.

    ``prep(state, psi, pol)`` turns a canonical state (plus a resumed
    canonical CPML psi / Debye polarization, or None) into the scan carry;
    ``restore(carry)`` returns the canonical FieldState; ``run_chunk(carry,
    chunk, power) -> (carry, power)`` advances one chunk, ``chunk`` being
    ``(ts, amps)`` plus the DFT weight rows when a DFT is on.  ``psi`` and
    ``pol`` read the canonical checkpoint layouts back out of a carry.
    ``dft_box["acc"]`` holds the running DFT sums and ``probe_chunks`` the
    probe rows, for monitored runs."""

    prep: Callable
    restore: Callable
    run_chunk: Callable
    psi: Callable | None = None
    pol: Callable | None = None
    dft_box: dict | None = None
    probe_chunks: list | None = None


def build_chunk_runner(
    p: Params,
    materials=None,
    accumulate_power: bool = False,
    shard: str | None = None,
    pml=None,
    dft=None,
    probes=None,
    backend: str = "auto",
) -> ChunkRunner:
    """Pick the path for a run from its inputs alone — the one dispatch.

    Every run takes the jnp step: single-device runs scan
    :mod:`fdtd_tpu.step` (or its CPML, ADE and monitored variants);
    ``shard`` runs the ``shard_map`` step of
    :mod:`fdtd_tpu.parallel.sharded_step` on a device mesh for every
    composition.  ``backend`` must be "auto" or "xla" (the same path).
    """
    from .ops.cpml import init_psi
    from .ops.dispersive import DebyeMaterials, zero_polarization
    from .step import check_backend

    check_backend(backend)
    dispersive = isinstance(materials, DebyeMaterials)
    monitored = dft is not None or probes is not None
    if accumulate_power and materials is None and (pml is not None
                                                   or shard is not None):
        raise ValueError("--sar needs lossy materials (e.g. --water-block)")
    if dispersive and pml is not None and shard is not None:
        raise ValueError(
            "dispersive media with --pml run single-device for now "
            "(no --shard)"
        )
    pick = lambda given, default: default if given is None else given
    dft_box, probe_chunks = _monitor_boxes(p, dft)
    boxes = dict(dft_box=dft_box, probe_chunks=probe_chunks)

    if shard is not None:
        from .parallel.mesh import (
            field_sharding,
            pad_state_for_mesh,
            padded_divisible_shape,
            unpad_state,
        )
        from .parallel import sharded_step as ss

        mesh = shard_mesh(shard)
        K, J, I = p.maxk, p.maxj, p.maxi
        K1, J1, I1 = p.padded_shape
        Kp, Jp, Ip = padded_divisible_shape(p, mesh)
        fsh = field_sharding(mesh)

        def pad_put(a, shape):
            a = jnp.asarray(a)
            pads = tuple((0, t - n) for t, n in zip((Kp, Jp, Ip), shape))
            return jax.device_put(jnp.pad(a, pads), fsh)

        if dispersive:
            run = ss.make_sharded_dispersive_chunk_runner(
                p, mesh, materials, dft=dft, probes=probes,
                accumulate_power=accumulate_power,
            )

            def prep(s, psi=None, pol=None):
                pol = pick(pol, zero_polarization(p))
                return (pad_state_for_mesh(p, s, mesh),
                        tuple(pad_put(a, (K1, J1, I1)) for a in pol))

            restore = lambda c: unpad_state(p, c[0])
            pol_of = lambda c: tuple(a[:K1, :J1, :I1] for a in c[1])
            psi_of = None
        else:
            run = ss.make_sharded_monitored_chunk_runner(
                p, mesh, materials, pml=pml,
                accumulate_power=accumulate_power, dft=dft, probes=probes,
            )
            pol_of = None
            if pml is not None:
                def prep(s, psi=None, pol=None):
                    psi12 = (ss.embed_psi12(p, pml, psi, mesh)
                             if psi is not None else run.zero_psi())
                    return (pad_state_for_mesh(p, s, mesh), psi12)

                restore = lambda c: unpad_state(p, c[0])
                psi_of = jax.jit(lambda c: ss.extract_psi12(p, pml, c[1]))
            else:
                prep = lambda s, psi=None, pol=None: pad_state_for_mesh(
                    p, s, mesh)
                restore = lambda c: unpad_state(p, c)
                psi_of = None

        def run_padded(carry, xs, power, dacc):
            # the accumulator is canonical (maxk, maxj, maxi) between
            # chunks, so checkpoints interoperate with single-device runs
            if power is not None:
                power = pad_put(power, (K, J, I))
            carry, power, dacc, ys = run(carry, xs, power, dacc)
            if power is not None:
                power = power[:K, :J, :I]
            return carry, power, dacc, ys

        return ChunkRunner(
            prep, restore,
            _monitored_run_chunk(run_padded, dft_box, probe_chunks),
            psi=psi_of, pol=pol_of, **boxes,
        )

    if dispersive:
        if pml is not None:
            from .ops.dispersive import make_dispersive_pml_chunk_runner

            run = make_dispersive_pml_chunk_runner(
                p, materials, pml, dft=dft, probes=probes,
                accumulate_power=accumulate_power,
            )

            def prep(s, psi=None, pol=None):
                return (s, pick(pol, zero_polarization(p)),
                        pick(psi, init_psi(p, pml)))

            psi_of = lambda c: c[2]
        else:
            from .ops.dispersive import make_dispersive_chunk_runner

            run = make_dispersive_chunk_runner(
                p, materials, dft=dft, probes=probes,
                accumulate_power=accumulate_power,
            )
            prep = lambda s, psi=None, pol=None: (
                s, pick(pol, zero_polarization(p)))
            psi_of = None
        return ChunkRunner(
            prep, lambda c: c[0],
            _monitored_run_chunk(run, dft_box, probe_chunks),
            psi=psi_of, pol=lambda c: c[1], **boxes,
        )

    if pml is not None:
        from .ops.cpml import make_pml_chunk_runner

        run = make_pml_chunk_runner(p, pml, materials, accumulate_power,
                                    dft=dft, probes=probes)
        if monitored:
            run = _monitored_run_chunk(run, dft_box, probe_chunks)
        return ChunkRunner(
            lambda s, psi=None, pol=None: (s, pick(psi, init_psi(p, pml))),
            lambda c: c[0], run, psi=lambda c: c[1], **boxes,
        )

    if monitored:
        from .monitors import make_monitored_chunk_runner

        run = make_monitored_chunk_runner(
            p, materials, dft=dft, probes=probes,
            accumulate_power=accumulate_power,
        )
        run = _monitored_run_chunk(run, dft_box, probe_chunks)
    else:
        run = make_chunk_runner(p, materials,
                                accumulate_power=accumulate_power)
    return ChunkRunner(lambda s, psi=None, pol=None: s, lambda s: s, run,
                       **boxes)


def run_simulation(
    p: Params,
    out_dir: str = "r",
    materials: Materials | None = None,
    backend: str = "auto",
    write_snapshots: bool = True,
    accumulate_power: bool = False,
    checkpoint_every: int = 0,
    resume: bool = False,
    quirk_compat: bool = True,
    log: Callable[[str], None] = print,
    diagnostics_log: str | None = None,
    shard: str | None = None,
    pml=None,
    dft=None,
    probes=None,
) -> RunResult:
    p.validate()
    ts = time_values(p)
    xs_t, xs_a = scan_inputs(p, ts)
    if dft is not None:
        from .dft import dft_weights

        dft_cw, dft_sw = dft_weights(dft, ts)
    warnings: list[str] = []

    def warn(msg: str) -> None:
        warnings.append(msg)
        log(f"WARNING: {msg}")

    if dft is not None:
        mem_msg = _dft_memory_note(p, dft)
        if mem_msg:
            warn(mem_msg)

    if jnp.dtype(p.dtype) == jnp.bfloat16 and (
        p.mode == Mode.VALIDATION or len(ts) > 2000
    ):
        # bf16 storage reached e_r ~ 17% after 55k validation steps
        # (docs/DESIGN.md precision guidance) — fine for design sweeps and
        # heating totals, wrong for accuracy studies
        warn(
            "bfloat16 field storage accumulates leapfrog round-off "
            "(measured e_r ~ 17% after 55k validation steps); use float32 "
            "for validation/accuracy runs"
        )

    from .ops.dispersive import DebyeMaterials

    dispersive = isinstance(materials, DebyeMaterials)
    runner = build_chunk_runner(
        p, materials, accumulate_power, shard=shard, pml=pml, dft=dft,
        probes=probes, backend=backend,
    )
    run_chunk = runner.run_chunk
    dft_box, probe_chunks = runner.dft_box, runner.probe_chunks

    state = initial_state(p)
    power = zero_power_acc(p) if accumulate_power else None
    start_step = 0

    resumed_psi = None
    resumed_pol = None
    resumed_dft = False
    if resume:
        ck = latest_checkpoint(out_dir)
        if ck:
            state, it_done, _t, ck_power = load_checkpoint(ck, p)
            start_step = it_done
            if dft is not None or probes is not None:
                # monitor accumulators ride checkpoints (r4): the DFT
                # running sums resume as aux arrays like psi/pol; probe
                # rows recorded so far reload so the final series covers
                # the whole schedule
                from .io.checkpoint import load_aux

                aux_m = load_aux(ck)
                if dft is not None:
                    if "dft_re" in aux_m and "dft_im" in aux_m:
                        dft_box["acc"] = (
                            jnp.asarray(aux_m["dft_re"]),
                            jnp.asarray(aux_m["dft_im"]),
                        )
                        resumed_dft = True
                    else:
                        log(
                            "WARNING: checkpoint has no DFT accumulators; "
                            "the phasor sums restart from zero (spectra "
                            "cover only the resumed steps)"
                        )
                if probes is not None:
                    if "probe_rows" in aux_m:
                        rows = np.asarray(aux_m["probe_rows"], np.float32)
                        if rows.shape[0]:
                            probe_chunks.append(rows)
                    else:
                        log(
                            "WARNING: checkpoint has no probe rows; the "
                            "series covers only the resumed steps"
                        )
            if dispersive:
                from .io.checkpoint import load_aux

                aux = load_aux(ck)
                names = ("pol_x", "pol_y", "pol_z")
                if all(n in aux for n in names):
                    resumed_pol = tuple(jnp.asarray(aux[n]) for n in names)
                else:
                    log(
                        "WARNING: checkpoint has no polarization state; "
                        "the Debye memory restarts from zero (the medium "
                        "will see a transient)"
                    )
            if accumulate_power:
                if ck_power is not None:
                    power = ck_power
                else:
                    log(
                        "WARNING: checkpoint has no power accumulator; "
                        "--sar totals restart from zero at this point"
                    )
            if pml is not None:
                from .io.checkpoint import load_aux
                from .ops.cpml import PsiState, psi_shapes

                aux = load_aux(ck)
                names = list(PsiState.__dataclass_fields__)
                shapes = psi_shapes(p, pml)
                ok = all(
                    f"psi_{n}" in aux and aux[f"psi_{n}"].shape == shapes[n]
                    for n in names
                )
                if ok:
                    resumed_psi = PsiState(
                        **{n: jnp.asarray(aux[f"psi_{n}"]) for n in names}
                    )
                else:
                    log(
                        "WARNING: checkpoint has no (or differently-"
                        "shaped) CPML psi state; the absorber memory "
                        "restarts from zero (fields in the slabs will "
                        "see a transient)"
                    )
            log(f"Resuming from {ck} (after step {it_done})")

    # one compiled dispatch per boundary, not an eager-op chain
    restore = jax.jit(runner.restore)
    state = runner.prep(state, resumed_psi, resumed_pol)

    ckpt_writer = CheckpointWriter(out_dir) if checkpoint_every else None
    writer = SnapshotWriter(p, out_dir) if write_snapshots else None
    diag_f = open(diagnostics_log, "a") if diagnostics_log else None

    # One compiled dispatch per snapshot/diagnostic instead of a storm of
    # eager ops.
    agg_j = jax.jit(lambda s: aggregate_all(p, s))
    energies_j = jax.jit(
        lambda s: (diagnostics.e_energy(p, s), diagnostics.h_energy(p, s))
    )
    flux_j = None
    if pml is not None and diagnostics_log:
        # open-boundary runs also log the instantaneous radiated power
        # through the box one cell inside the absorber (clamped to the
        # largest box the grid admits; tiny grids skip the flux)
        _fm = min(pml.cells + 1, min(p.maxk, p.maxj, p.maxi) // 2 - 1)
        if _fm >= 0:
            flux_j = jax.jit(
                lambda s, _m=_fm: diagnostics.poynting_flux(p, s, margin=_m)
            )

    def snapshot(s: FieldState, iteration: int, t: float):
        if writer is None:
            return
        variables = dict(agg_j(s))
        if p.mode == Mode.VALIDATION:
            # analytic fields are host-precomputed fp64 per t (not jittable)
            variables.update(validation_extras(p, s, t, quirk_compat=quirk_compat))
        writer.submit(variables, iteration, t)

    def log_diag(s: FieldState, iteration: int, t: float):
        if diag_f is None:
            return
        e_d, h_d = energies_j(s)
        e, h = float(e_d), float(h_d)
        rec = {"iteration": iteration, "t": t, "E_energy": e, "H_energy": h, "total": e + h}
        if flux_j is not None:
            rec["radiated_W"] = float(flux_j(s))
        diag_f.write(json.dumps(rec) + "\n")
        # failure detection: a CFL-unstable or NaN run is caught at the next
        # sample instead of burning the remaining schedule (the reference
        # required killing runs by hand, description.pdf section 3.1)
        if not math.isfinite(e + h):
            diag_f.flush()
            raise RuntimeError(
                f"simulation diverged (non-finite energy) at iteration {iteration}; "
                f"last state checkpointed snapshots are in {out_dir!r}"
            )

    n = len(ts)
    rate = max(1, p.sampling_rate)

    if start_step == 0:
        # Initial snapshot at iteration 1 (reference: main.c:758-764).
        full = restore(state)
        snapshot(full, 1, 0.0)
        log_diag(full, 0, 0.0)
        jax.block_until_ready(full.ex)

    t0 = time.perf_counter()
    pos = start_step
    next_mult = lambda x, m: ((x // m) + 1) * m
    while pos < n:
        # next snapshot boundary: smallest multiple of rate > pos (1-based
        # steps); checkpoint boundaries are independent of the snapshot
        # cadence, so e.g. --checkpoint-every 15 with rate 10 checkpoints at
        # 15, 30, 45, ... (not only at common multiples)
        boundary = next_mult(pos, rate)
        if checkpoint_every:
            boundary = min(boundary, next_mult(pos, checkpoint_every))
        end = min(boundary, n)
        chunk = (xs_t[pos:end], xs_a[pos:end])
        if dft is not None:
            chunk = chunk + (dft_cw[pos:end], dft_sw[pos:end])
        state, power = run_chunk(state, chunk, power)
        pos = end
        t_now = float(ts[pos - 1])
        if pos % rate == 0 or (checkpoint_every and pos % checkpoint_every == 0):
            full = restore(state)
        if pos % rate == 0:
            snapshot(full, pos, t_now)
            log_diag(full, pos, t_now)
        if checkpoint_every and pos % checkpoint_every == 0:
            # async: the worker thread does the device->host copy + write
            # while the next chunk runs (see io.checkpoint.CheckpointWriter)
            aux = {}
            if dft is not None:
                re_a, im_a = dft_box["acc"]
                aux["dft_re"] = re_a
                aux["dft_im"] = im_a
            if probes is not None:
                aux["probe_rows"] = (
                    np.concatenate(probe_chunks, axis=0)
                    if probe_chunks
                    else np.zeros((0, len(probes.cells), 6), np.float32))
            if pml is not None:
                psi = runner.psi(state)
                aux.update({f"psi_{n}": getattr(psi, n)
                            for n in type(psi).__dataclass_fields__})
            if dispersive:
                # canonical (K1, J1, I1) polarization layout whatever the
                # carry holds — checkpoints interoperate across topologies
                aux.update(zip(("pol_x", "pol_y", "pol_z"),
                               runner.pol(state)))
            ckpt_writer.submit(full, pos, t_now, power=power,
                               aux=aux or None)

    state = restore(state)
    jax.block_until_ready(state.ex)
    wall = time.perf_counter() - t0

    if ckpt_writer is not None:
        ckpt_writer.close()
    if writer is not None:
        writer.close()
    if diag_f is not None:
        diag_f.close()

    steps_done = n - start_step
    mcells = p.cell_count * steps_done / wall / 1e6 if wall > 0 else float("inf")
    dft_result = None
    if dft is not None:
        from .dft import finalize

        # a resumed accumulator covers the WHOLE schedule (the running
        # sums rode the checkpoint), so normalize by n, not steps_done
        dft_result = finalize(dft, dft_box["acc"],
                              n if resumed_dft else steps_done,
                              time_step=p.time_step)
    probe_result = None
    if probes is not None:
        from .monitors import ProbeResult

        values = (np.concatenate(probe_chunks, axis=0)
                  if probe_chunks else
                  np.zeros((0, len(probes.cells), 6), np.float32))
        probe_result = ProbeResult(
            cells=probes.cells,
            # align times to the recorded rows (a resume without stored
            # probe rows covers only the resumed tail)
            times=np.asarray(ts, np.float64)[n - values.shape[0]:],
            values=values,
        )
    return RunResult(state, n, wall, mcells, power, warnings,
                     dft=dft_result, probes=probe_result)
