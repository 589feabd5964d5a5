"""Every flag combination the CLI and ``run_simulation`` accept, as test
parameters: materials x --pml x --dft/--probe x --sar x --dispersive x
--shard, minus the combinations they refuse."""

import itertools

MATERIALS = ("vacuum", "water", "water+ferrite")
MONITORS = ("none", "dft", "probe")


def accepted(materials, pml, sar, dispersive, shard):
    if dispersive and materials != "water":
        return False  # the Debye description of the water load only
    if dispersive and pml and shard:
        return False  # refused: dispersive --pml runs single-device
    if sar and materials == "vacuum" and (pml or shard):
        return False  # refused: --sar needs a lossy load there
    return True


def combos(sharded: bool):
    shard = "2" if sharded else None
    out = []
    for mats, pml, mon, sar, disp in itertools.product(
            MATERIALS, (0, 3), MONITORS, (False, True), (False, True)):
        if accepted(mats, pml, sar, disp, shard):
            out.append((mats, pml, mon, sar, disp, shard))
    return out


def combo_id(c):
    mats, pml, mon, sar, disp, shard = c
    parts = [mats, f"pml{pml}", mon]
    if sar:
        parts.append("sar")
    if disp:
        parts.append("dispersive")
    if shard:
        parts.append(f"shard{shard}")
    return "-".join(parts)


def run_combo(c):
    """Build the dispatch's runner for the combination and run 2 steps
    through ``run_simulation``; checks what the runner carries and what
    the run returns."""
    import numpy as np

    from fdtd_tpu.dft import DftConfig
    from fdtd_tpu.monitors import ProbeSet
    from fdtd_tpu.ops.cpml import PMLConfig
    from fdtd_tpu.ops.dispersive import water_debye_load
    from fdtd_tpu.params import Mode, Params
    from fdtd_tpu.runner import ChunkRunner, build_chunk_runner, run_simulation
    from fdtd_tpu.state import ferrite_slab, water_block

    mats, pml, mon, sar, disp, shard = c
    p = Params(length=0.008, width=0.008, height=0.008, spatial_step=0.001,
               time_step=1e-12, simulation_time=1.5e-12, sampling_rate=10**9,
               mode=Mode.COMPUTATION, dtype="float32")
    materials = None
    if disp:
        materials = water_debye_load(p)
    elif mats != "vacuum":
        materials = water_block(p)
        if mats == "water+ferrite":
            materials = ferrite_slab(p, base=materials)
    kw = dict(
        materials=materials, accumulate_power=sar, shard=shard,
        pml=PMLConfig(cells=pml) if pml else None,
        dft=DftConfig((2.45e10,)) if mon == "dft" else None,
        probes=ProbeSet(((4, 4, 4),)) if mon == "probe" else None,
    )
    runner = build_chunk_runner(p, **kw)
    assert isinstance(runner, ChunkRunner)
    assert (runner.psi is not None) == bool(pml)
    assert (runner.pol is not None) == disp
    res = run_simulation(p, write_snapshots=False, log=lambda s: None, **kw)
    assert res.iterations == 2
    for c_ in ("ex", "ey", "ez", "hx", "hy", "hz"):
        a = np.asarray(getattr(res.state, c_), np.float32)
        assert a.shape == p.padded_shape and np.isfinite(a).all(), c_
    assert float(np.abs(np.asarray(res.state.ez, np.float32)).max()) > 0
    assert (res.power_j is not None) == sar
    assert (res.dft is not None) == (mon == "dft")
    if mon == "probe":
        assert res.probes.values.shape == (2, 1, 6)
