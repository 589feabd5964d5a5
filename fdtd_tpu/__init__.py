"""fdtd_tpu — a JAX Yee-FDTD electromagnetic simulation framework.

A ground-up JAX/XLA rebuild of the capabilities of the reference
microwave-oven FDTD solver (Ethalides33/FDTD-Maxwell-microwave-oven):
leapfrog curl updates as fused device kernels, PEC cavity walls by
construction, TE10 waveguide-port source, TE101 analytical validation
oracle, energy/SAR diagnostics, VTK/NPZ snapshot streaming, and spatial
domain decomposition over a ``jax.sharding.Mesh`` with one-cell halo
exchange — the device-mesh analogue of the reference's MPI slab
decomposition.
"""

from .params import Mode, Params, SourceConfig, load_parameters, parse_params_text, time_values, num_steps
from .state import (
    FieldState,
    Materials,
    block_mask,
    cylinder_mask,
    init_validation,
    sphere_mask,
    update_coefs,
    water_block,
    water_from_mask,
    zeros,
)
from .step import make_step, make_chunk_runner
from .ops.cpml import PMLConfig
from .ops.dispersive import DebyeMaterials, water_debye_load
from .thermal import ThermalMaterials, air_thermal, run_thermal, water_thermal
from .coupled import CoupledResult, run_coupled, water_debye
from .turntable import LoadGeometry, geometry_mask, rotate_field
from .dft import DftConfig, DftResult
from .monitors import ProbeResult, ProbeSet
from . import analytic, diagnostics, grid

__all__ = [
    "Mode",
    "Params",
    "SourceConfig",
    "load_parameters",
    "parse_params_text",
    "time_values",
    "num_steps",
    "FieldState",
    "Materials",
    "zeros",
    "init_validation",
    "update_coefs",
    "water_block",
    "make_step",
    "make_chunk_runner",
    "PMLConfig",
    "DebyeMaterials",
    "water_debye_load",
    "CoupledResult",
    "run_coupled",
    "water_debye",
    "LoadGeometry",
    "geometry_mask",
    "rotate_field",
    "DftConfig",
    "DftResult",
    "ProbeResult",
    "ProbeSet",
    "block_mask",
    "sphere_mask",
    "cylinder_mask",
    "water_from_mask",
    "ThermalMaterials",
    "air_thermal",
    "run_thermal",
    "water_thermal",
    "analytic",
    "diagnostics",
    "grid",
]

__version__ = "0.1.0"
