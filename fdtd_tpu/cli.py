"""Command-line driver — drop-in UX for the reference binary.

``python -m fdtd_tpu params.txt`` mirrors ``./microwave params.txt``
(reference: main.c:807-853), including the banner prints and the
single-positional-argument contract, while adding opt-in flags for the
capabilities the reference lacks (materials, precision, backend, resume,
SAR accumulation, no-output benchmarking).
"""

from __future__ import annotations

import argparse
import sys

from .params import Mode, load_parameters
from .runner import run_simulation
from .state import ferrite_slab


def _backend_arg(name: str) -> str:
    """argparse type for --backend: the removed tier names fail here, at
    parsing, with the reason."""
    from .step import check_backend

    try:
        check_backend(name)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return name


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="fdtd_tpu",
        description="JAX FDTD microwave-oven simulator (params.txt compatible)",
    )
    ap.add_argument("params", help="parameters file (.txt), 8 ordered scalars")
    ap.add_argument("--out", default="r", help="output directory (default: r, like the reference)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
    ap.add_argument(
        "--backend", default="auto", type=_backend_arg, metavar="{auto,xla}",
        help="update path: every run takes the jnp step, so auto and xla "
             "are the same (kept for existing scripts)")
    ap.add_argument("--no-output", action="store_true", help="skip snapshots (benchmark mode)")
    ap.add_argument("--water-block", action="store_true", help="place a water load in the cavity")
    ap.add_argument("--ferrite-slab", action="store_true",
                    help="add a mu_r=4 ferrite shelf (heterogeneous mu; composes with --water-block)")
    ap.add_argument("--sar", action="store_true", help="accumulate power deposition (J/m^3)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N", help="checkpoint every N steps")
    ap.add_argument("--resume", action="store_true", help="resume from latest checkpoint in --out")
    ap.add_argument("--diag-log", default=None, help="JSONL per-sample energy log path")
    ap.add_argument("--physics-correct", action="store_true",
                    help="disable reference-quirk compatibility in exported validation vars")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the run to DIR")
    ap.add_argument("--source-frequency", type=float, default=None, metavar="HZ",
                    help="magnetron drive frequency (reference hardcodes 2.45e10, main.c:735)")
    ap.add_argument("--source-aprime", type=float, default=None, metavar="M",
                    help="source patch width a' (reference hardcodes 0.005, main.c:720)")
    ap.add_argument("--source-bprime", type=float, default=None, metavar="M",
                    help="source patch depth b' (reference hardcodes 0.005, main.c:721)")
    ap.add_argument("--shard", default=None, metavar="ZxY",
                    help="spatial decomposition over devices, e.g. 4 (z-slabs) "
                         "or 4x2 (z*y) — the reference MPI branch's 'mpirun -np N' "
                         "as a flag; needs that many JAX devices")
    ap.add_argument("--pml", type=int, default=0, metavar="N",
                    help="CPML absorbing boundaries, N cells per face "
                         "(0 = closed PEC cavity like the reference; "
                         "open-boundary extension)")
    ap.add_argument("--source-envelope", default=None,
                    choices=["cw", "gaussian"],
                    help="drive envelope: cw (reference behavior) or a "
                         "gaussian-modulated burst for transient studies")
    ap.add_argument("--source-pulse-width", type=float, default=None,
                    metavar="S", help="gaussian envelope sigma in seconds "
                    "(default: 2 carrier periods)")
    ap.add_argument("--source-pulse-delay", type=float, default=None,
                    metavar="S", help="gaussian envelope center in seconds "
                    "(default: 3 widths)")
    ap.add_argument("--thermal", type=float, default=None, metavar="SECONDS",
                    help="after the EM run, integrate the heat equation for "
                         "SECONDS of cook time driven by the SAR map "
                         "(needs --sar and a lossy load, e.g. --water-block); "
                         "writes temperature.vtr")
    ap.add_argument("--dft", default=None, metavar="HZ[,HZ...]",
                    help="accumulate on-the-fly DFT phasors of the E field "
                         "at these frequencies (comma-separated Hz); writes "
                         "per-frequency dft_NN.vtr complex field maps, |E|, "
                         "and the CW power deposition for lossy loads")
    ap.add_argument("--load-shape", default="box",
                    choices=["box", "sphere", "cylinder"],
                    help="geometry of the --water-block load: the default "
                         "0.3-0.7 box, a centered sphere, or a z-axis "
                         "cylinder (the mug); applies to EM, thermal, "
                         "coupled, and dispersive paths alike")
    ap.add_argument("--dispersive", action="store_true",
                    help="make the --water-block load a true single-pole "
                         "Debye medium solved by the ADE method (frequency-"
                         "dependent eps(w) in the time domain)")
    ap.add_argument("--dft-fields", default="e", choices=["e", "eh"],
                    help="DFT components: 'e' (default) or 'eh' (all six, "
                         "enabling the cycle-averaged Poynting map)")
    ap.add_argument("--probe", action="append", default=None,
                    metavar="K,J,I",
                    help="record a per-step time series of the six "
                         "cell-centered field components at cell (k,j,i); "
                         "repeatable; writes probes.csv")
    ap.add_argument("--coupled", type=int, default=0, metavar="N",
                    help="two-way EM<->thermal coupling: split the --thermal "
                         "cook time into N quasi-static intervals, re-deriving "
                         "the load's eps_r/sigma from its temperature (Debye "
                         "water model) before each interval's EM solve")
    ap.add_argument("--thermal-power", type=float, default=None,
                    metavar="WATTS",
                    help="rescale the deposited-power map so total absorbed "
                         "power equals WATTS (e.g. the magnetron rating) "
                         "before the thermal solve")
    ap.add_argument("--salt-sigma", type=float, default=0.0, metavar="S_M",
                    help="ionic conductivity of the load at 25 C in S/m for "
                         "the coupled Debye model (salty food heats harder "
                         "when hot; default 0 = pure water)")
    ap.add_argument("--thermal-ambient", type=float, default=20.0,
                    metavar="C", help="initial/ambient temperature "
                    "(default 20 C)")
    ap.add_argument("--rotate", type=float, default=0.0, metavar="RPM",
                    help="turntable rotation: spin the --water-block load "
                         "at RPM about the vertical cavity axis during a "
                         "--coupled cook (each interval re-rasterizes the "
                         "load at its mid-interval angle; heat integrates "
                         "in the load's co-rotating frame)")
    ap.add_argument("--load-center", default=None, metavar="X,Y",
                    help="(x, y) center of the load as box fractions "
                         "(default 0.5,0.5); off-center loads are what make "
                         "--rotate matter")
    return ap


def _pml_config(cells: int):
    if not cells:
        return None
    from .ops.cpml import PMLConfig

    return PMLConfig(cells=cells)


def _parse_load_center(args) -> tuple:
    """(x, y) load center as box fractions from --load-center (default
    centered); raises ValueError on a malformed spec."""
    if not args.load_center:
        return (0.5, 0.5)
    parts = args.load_center.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"--load-center wants X,Y fractions, got {args.load_center!r}"
        )
    cx, cy = (float(v) for v in parts)
    if not (0.0 < cx < 1.0 and 0.0 < cy < 1.0):
        raise ValueError("--load-center fractions must be in (0, 1)")
    return (cx, cy)


def _run_coupled_cli(args, p, load_mask=None, dft_cfg=None) -> int:
    """--coupled N: the two-way EM <-> thermal driver (fdtd_tpu/coupled.py)."""
    import json
    import os

    import numpy as np

    from . import grid
    from .coupled import run_coupled
    from .io.vtr import write_vtr

    if args.thermal is None:
        print("error: --coupled needs --thermal SECONDS (the cook time)",
              file=sys.stderr)
        return 1
    if p.mode != Mode.COMPUTATION:
        print("error: --coupled needs computation mode (a driven source "
              "heats the load; set the params-file mode to 1)",
              file=sys.stderr)
        return 1
    if not args.water_block:
        print("error: --coupled needs --water-block (the heated load whose "
              "dielectrics track temperature)", file=sys.stderr)
        return 1
    if args.ferrite_slab:
        print("error: --coupled models the water load only (no --ferrite-"
              "slab)", file=sys.stderr)
        return 1
    geometry = None
    if args.rotate:
        from .turntable import LoadGeometry

        center = _parse_load_center(args)
        geometry = LoadGeometry(shape=args.load_shape, center=center)
        load_mask = None  # run_coupled rasterizes the geometry itself
        print(f"Turntable: {args.rotate:g} rpm about the cavity axis "
              f"({args.coupled} angle samples over the cook)")
    print(f"Coupled EM<->thermal cook: {args.thermal:g} s over "
          f"{args.coupled} interval(s); Debye dielectrics at "
          f"{p.source.frequency:.3g} Hz (note the reference drives at "
          f"2.45e10, not 2.45e9 — override with --source-frequency)")
    on_interval = None
    if not args.no_output:
        os.makedirs(args.out, exist_ok=True)
        coords = grid.node_coords(p)

        def on_interval(it, T, theta):
            # per-interval maps: load temperature_*.vtr as a time series
            # in ParaView/VisIt to animate the cook.  T is in the load's
            # co-rotating MATERIAL frame; under --rotate also write the
            # lab-frame map at this interval's angle so the animation
            # shows the load actually moving and stays comparable with
            # the lab-frame SAR/DFT maps.
            if theta:
                from .turntable import rotate_field

                variables = {
                    "temperature_c_material_frame": T,
                    "temperature_c_lab": rotate_field(
                        p, T, theta, fill=args.thermal_ambient
                    ),
                }
            else:
                variables = {"temperature_c": T}
            write_vtr(os.path.join(args.out, f"temperature_{it:02d}.vtr"),
                      coords, variables)

    on_interval_dft = None
    if dft_cfg is not None and not args.no_output:
        os.makedirs(args.out, exist_ok=True)
        coords_d = grid.node_coords(p)

        def on_interval_dft(it, dres, sigma_cells, theta):
            # per-interval phasor maps (r5, VERDICT r4 #7): how the
            # steady-state pattern shifts as the load heats — load
            # dft_iNN_MM.vtr as a time series next to temperature_NN.vtr
            comps = ("ex", "ey", "ez", "hx", "hy", "hz")
            for fi, f in enumerate(dft_cfg.frequencies):
                variables = {"e_mag": dres.magnitude(fi),
                             "cw_power_w_m3": dres.cw_power(sigma_cells,
                                                            fi)}
                for ci in range(dres.phasors.shape[1]):
                    ph = dres.phasors[fi, ci]
                    variables[f"{comps[ci]}_re"] = np.real(ph)
                    variables[f"{comps[ci]}_im"] = np.imag(ph)
                write_vtr(
                    os.path.join(args.out, f"dft_i{it:02d}_{fi:02d}.vtr"),
                    coords_d, variables,
                )

    try:
        res = run_coupled(
            p,
            cook_time=args.thermal,
            intervals=args.coupled,
            mask=load_mask,
            geometry=geometry,
            rpm=args.rotate,
            frequency=p.source.frequency,
            sigma_ion25=args.salt_sigma,
            power_watts=args.thermal_power,
            ambient=args.thermal_ambient,
            backend=args.backend,
            shard=args.shard,
            pml=_pml_config(args.pml),
            out_dir=args.out,
            on_interval=on_interval,
            dft=dft_cfg,
            on_interval_dft=on_interval_dft,
            # --checkpoint-every under --coupled means interval-level
            # checkpointing (any N > 0): each EM interval restarts from a
            # zero field, so there is no meaningful intra-interval state
            checkpoint=bool(args.checkpoint_every),
            resume=args.resume,
        )
    except (NotImplementedError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    T = res.temperature
    if not args.no_output:
        os.makedirs(args.out, exist_ok=True)
        t_path = os.path.join(args.out, "temperature.vtr")
        if res.final_theta:
            # material-frame + end-of-cook lab-frame maps, frames named
            # explicitly (ADVICE r3: an unannotated material-frame map
            # misleads comparisons against lab-frame SAR/DFT fields)
            from .turntable import rotate_field

            write_vtr(t_path, grid.node_coords(p), {
                "temperature_c_material_frame": T,
                "temperature_c_lab": rotate_field(
                    p, T, res.final_theta, fill=args.thermal_ambient
                ),
            })
            print(f"Turntable end-of-cook angle "
                  f"{np.degrees(res.final_theta):.1f} deg; temperature.vtr "
                  "carries both the material-frame and lab-frame maps")
        else:
            write_vtr(t_path, grid.node_coords(p), {"temperature_c": T})
        log_path = os.path.join(args.out, "coupled.jsonl")
        with open(log_path, "w") as f:
            for s in res.intervals:
                f.write(json.dumps(s) + "\n")
        print(f"Temperature map written to {t_path}; interval log to "
              f"{log_path}")
    hot = tuple(int(c) for c in
                np.unravel_index(int(res.rise.argmax()), res.rise.shape))
    first, last = res.intervals[0], res.intervals[-1]
    print(f"Peak temperature {T.max():.2f} C "
          f"(rise {res.rise.max():.3e} K) at cell (k,j,i)={hot}")
    print(f"Load eps_r drifted {first['eps_r_range'][1]:.1f} -> "
          f"{last['eps_r_range'][1]:.1f}, sigma "
          f"{first['sigma_range'][1]:.3f} -> "
          f"{last['sigma_range'][1]:.3f} S/m over the cook")
    print("Simulation complete!")
    return 0


def main(argv=None) -> int:
    print("Welcome into our microwave oven eletrico-magnetic field simulator! \n", end="")
    args = build_arg_parser().parse_args(argv)

    print("Loading the parameters...")
    try:
        import dataclasses

        from .params import SourceConfig

        src_kw = {}
        if args.source_frequency is not None:
            src_kw["frequency"] = args.source_frequency
        if args.source_aprime is not None:
            src_kw["aprime"] = args.source_aprime
        if args.source_bprime is not None:
            src_kw["bprime"] = args.source_bprime
        if args.source_envelope is not None:
            src_kw["envelope"] = args.source_envelope
        if args.source_pulse_width is not None:
            src_kw["pulse_width"] = args.source_pulse_width
        if args.source_pulse_delay is not None:
            src_kw["pulse_delay"] = args.source_pulse_delay
        p = load_parameters(args.params, dtype=args.dtype)
        if src_kw:
            p = dataclasses.replace(p, source=dataclasses.replace(p.source, **src_kw))
        p.validate()
    except FileNotFoundError:
        # same UX as the reference's fail() (main.c:221-223)
        print("Unable to open parameters file!", file=sys.stderr)
        return 1
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if not p.is_cfl_stable():
        print(
            f"WARNING: time_step {p.time_step:g} exceeds the CFL bound "
            f"{p.cfl_limit():g}; the run will be unstable",
            file=sys.stderr,
        )

    load_mask = None
    if args.water_block:
        from .state import (
            block_mask,
            cylinder_mask,
            sphere_mask,
            water_from_mask,
        )

        try:
            cx, cy = _parse_load_center(args)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        ox, oy = cx - 0.5, cy - 0.5  # offset from the centered defaults
        load_mask = (
            sphere_mask(p, center=(cx, cy, 0.5)) if args.load_shape == "sphere"
            else cylinder_mask(p, center=(cx, cy))
            if args.load_shape == "cylinder"
            else block_mask(p, lo=(0.3 + ox, 0.3 + oy, 0.3),
                            hi=(0.7 + ox, 0.7 + oy, 0.7))
        )
        materials = water_from_mask(p, load_mask)
    else:
        if args.load_shape != "box" or args.load_center:
            print("error: --load-shape/--load-center need --water-block "
                  "(they place the water load)", file=sys.stderr)
            return 1
        materials = None
    if args.rotate and not args.coupled:
        print("error: --rotate needs --coupled N (the turntable is sampled "
              "at N angles over the --thermal cook)", file=sys.stderr)
        return 1
    if args.ferrite_slab:
        materials = ferrite_slab(p, base=materials)
    if args.dispersive:
        if not args.water_block or args.ferrite_slab:
            print("error: --dispersive needs --water-block (and no "
                  "--ferrite-slab): it is the Debye description of the "
                  "water load", file=sys.stderr)
            return 1
        if args.coupled:
            print("error: --dispersive does not compose with --coupled "
                  "(the ADE already carries the frequency dependence)",
                  file=sys.stderr)
            return 1
        from .ops.dispersive import water_debye_load

        materials = water_debye_load(p, temperature=args.thermal_ambient,
                                     sigma_ion25=args.salt_sigma,
                                     mask=load_mask)

    if args.thermal is not None:
        if not args.sar and not args.coupled:
            print("error: --thermal needs --sar (the SAR map is the heat "
                  "source)", file=sys.stderr)
            return 1
        if args.thermal <= 0:
            print("error: --thermal duration must be positive seconds",
                  file=sys.stderr)
            return 1
    if args.thermal_power is not None and args.thermal_power <= 0:
        print("error: --thermal-power must be positive watts",
              file=sys.stderr)
        return 1

    probe_set = None
    if args.probe:
        from .monitors import ProbeSet

        try:
            cells = tuple(
                tuple(int(x) for x in spec.split(",")) for spec in args.probe
            )
            probe_set = ProbeSet(cells)
            probe_set.validate(p)
        except ValueError as e:
            print(f"error: bad --probe spec: {e}", file=sys.stderr)
            return 1

    dft_cfg = None
    if args.dft:
        from .dft import DftConfig

        try:
            dft_cfg = DftConfig(
                tuple(float(x) for x in args.dft.split(",")),
                fields=args.dft_fields,
            )
        except ValueError as e:
            print(f"error: bad --dft spec: {e}", file=sys.stderr)
            return 1

    if args.coupled:
        if probe_set is not None:
            print("error: --probe does not compose with --coupled "
                  "(per-step probe series mix the intervals' different "
                  "dielectric problems; run probes on a fixed-material "
                  "run)", file=sys.stderr)
            return 1
        return _run_coupled_cli(args, p, load_mask, dft_cfg=dft_cfg)

    print("Initializing fields")
    if p.mode == Mode.VALIDATION:
        print("Validation mode activated. ")
    print("Creating mesh")
    print("Setting initial conditions")
    print("Launching simulation")

    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    try:
        result = run_simulation(
            p,
            out_dir=args.out,
            materials=materials,
            backend=args.backend,
            write_snapshots=not args.no_output,
            accumulate_power=args.sar,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
            quirk_compat=not args.physics_correct,
            diagnostics_log=args.diag_log,
            shard=args.shard,
            pml=_pml_config(args.pml),
            dft=dft_cfg,
            probes=probe_set,
        )
    except NotImplementedError as e:
        # a feature combination the solver does not support
        print(f"error: unsupported configuration: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        # e.g. bad --shard spec, too few devices, --sar with --shard
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.profile:
        import jax

        jax.profiler.stop_trace()
        print(f"profiler trace written to {args.profile}")
    print(
        f"{result.iterations} iterations in {result.wall_seconds:.3f}s "
        f"({result.mcells_per_s:.1f} Mcells/s)"
    )

    if result.power_j is not None and (
            (args.sar and not args.no_output) or args.thermal is not None):
        import os

        import numpy as np

        from . import grid
        from .io.vtr import write_vtr

        acc = np.asarray(result.power_j, dtype=np.float64)
        t_em = result.iterations * p.time_step

        if args.sar and not args.no_output:
            sar_path = os.path.join(args.out, "sar.vtr")
            write_vtr(sar_path, grid.node_coords(p),
                      {"power_j_m3": acc, "avg_power_w_m3": acc / t_em})
            print(f"SAR map written to {sar_path} "
                  f"(peak {acc.max():.3e} J/m^3 over {t_em:.3e} s)")

        if args.thermal is not None:
            from .thermal import air_thermal, run_thermal

            from .thermal import thermal_from_mask

            tm = (thermal_from_mask(p, load_mask) if load_mask is not None
                  else air_thermal(p))
            q = acc / t_em
            if args.thermal_power is not None:
                from .coupled import normalize_power

                q = normalize_power(p, q, args.thermal_power)
                print(f"Deposited power normalized to "
                      f"{args.thermal_power:g} W total")
            print(f"Integrating the heat equation for {args.thermal:g} s "
                  f"of cook time")
            tr = run_thermal(p, tm, q, args.thermal,
                             ambient=args.thermal_ambient)
            T = tr.temperature
            rise = np.asarray(tr.rise, dtype=np.float64)
            if not args.no_output:
                t_path = os.path.join(args.out, "temperature.vtr")
                write_vtr(t_path, grid.node_coords(p), {"temperature_c": T})
                print(f"Temperature map written to {t_path}")
            hot = tuple(int(c) for c in
                        np.unravel_index(int(rise.argmax()), rise.shape))
            print(f"Peak temperature {T.max():.2f} C "
                  f"(rise {rise.max():.3e} K) at cell (k,j,i)={hot} "
                  f"(ambient {args.thermal_ambient:g} C, {tr.steps} thermal "
                  f"steps of {tr.dt:.3e} s)")
            qh = tuple(int(c) for c in
                       np.unravel_index(int(q.argmax()), q.shape))
            print(f"Peak deposited power {q.max():.3e} W/m^3 at {qh}")

    if result.probes is not None and not args.no_output:
        import os

        from .monitors import COMPONENTS

        pr = result.probes
        path = os.path.join(args.out, "probes.csv")
        header = ["t"] + [
            f"p{pi}_{c}" for pi in range(len(pr.cells)) for c in COMPONENTS
        ]
        with open(path, "w") as f:
            f.write("# probe cells (k,j,i): "
                    + "; ".join(str(c) for c in pr.cells) + "\n")
            f.write(",".join(header) + "\n")
            flat = pr.values.reshape(pr.values.shape[0], -1)
            for ti in range(flat.shape[0]):
                f.write(f"{pr.times[ti]:.9e},"
                        + ",".join(f"{v:.6e}" for v in flat[ti]) + "\n")
        print(f"Probe time series ({len(pr.cells)} cell(s), "
              f"{pr.values.shape[0]} steps) written to {path}")

    if result.dft is not None and not args.no_output:
        import os

        import numpy as np

        from . import grid
        from .io.vtr import write_vtr

        coords = grid.node_coords(p)
        comps = (("ex", "ey", "ez", "hx", "hy", "hz")
                 if result.dft.fields == "eh" else ("ex", "ey", "ez"))
        for fi, f in enumerate(result.dft.frequencies):
            ph = result.dft.phasors[fi]
            variables = {}
            for ci, name in enumerate(comps):
                variables[f"{name}_re"] = np.ascontiguousarray(ph[ci].real)
                variables[f"{name}_im"] = np.ascontiguousarray(ph[ci].imag)
            mag = result.dft.magnitude(fi)
            variables["e_mag"] = mag
            if result.dft.fields == "eh":
                S = result.dft.poynting(fi)
                for ci, name in enumerate(("s_x", "s_y", "s_z")):
                    variables[name] = np.ascontiguousarray(S[ci])
                variables["s_mag"] = np.sqrt((S**2).sum(axis=0))
            sig_map = None
            if args.dispersive and materials is not None:
                # dielectric + ionic loss at THIS frequency: the Debye
                # medium's sigma_eff(w), not the plain sigma map
                from .ops.dispersive import effective_sigma

                sig_map = effective_sigma(materials, f)
            elif materials is not None and materials.sigma is not None:
                sig_map = materials.sigma
            if sig_map is not None:
                variables["cw_power_w_m3"] = result.dft.cw_power(
                    sig_map, fi
                )
            path = os.path.join(args.out, f"dft_{fi:02d}.vtr")
            write_vtr(path, coords, variables)
            print(f"DFT phasors at {f:.6g} Hz written to {path} "
                  f"(peak |E| {mag.max():.3e}, {result.dft.steps} steps)")

    print("Simulation complete!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
