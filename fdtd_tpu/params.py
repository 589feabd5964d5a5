"""Simulation parameters and the params.txt-compatible parser.

The reference reads 8 whitespace-separated scalars in a fixed order
(reference: main.c:216-242): length, width, height, spatial_step, time_step,
simulation_time, sampling_rate, mode.  C parses the three box dimensions and
the simulation time with ``%f`` (i.e. *single* precision) and the two steps
with ``%lf`` (double), and — quirk — the mode with ``%x`` (hex).  Grid sizes
are then derived as ``maxi = (size_t)(length / spatial_step)`` with the
float32 value promoted to double (reference: main.c:237-239).  We reproduce
those exact semantics because they are observable (grid size, step count,
source phase all depend on them).

On top of the parity parser this module adds the structured configuration the
reference lacks: the source parameters that are hardcoded in C
(a'=b'=5 mm, f=2.45e10 Hz — reference: main.c:720-735) are promoted to a
``SourceConfig``; precision is selectable; materials are configured separately
(see :mod:`fdtd_tpu.state`).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Sequence

import numpy as np

from .constants import CELERITY


class Mode(enum.IntEnum):
    """Run mode (reference: main.c:37-41)."""

    VALIDATION = 0
    COMPUTATION = 1


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """TE10 waveguide-port source on the z=0 wall.

    Defaults replicate the constants hardcoded in the reference
    (reference: main.c:720-739): a 5mm x 5mm patch centered in the z=0
    plane, driven at ``frequency`` (the *code* uses 2.45e10; the report says
    2.45e9 — code wins for parity, and the value is configurable here).
    """

    frequency: float = 2.45e10
    aprime: float = 0.005
    bprime: float = 0.005
    # Drive envelope (capability extension; the reference is CW-only,
    # main.c:748).  "cw": sin(2*pi*f*t).  "gaussian": the same carrier
    # modulated by exp(-(t - delay)^2 / (2 width^2)) — a finite
    # broadband burst for transient/open-boundary (--pml) studies.
    # ``pulse_width`` defaults to 2 carrier periods, ``pulse_delay`` to
    # 3 widths (so the drive starts near zero).
    envelope: str = "cw"
    pulse_width: float | None = None
    pulse_delay: float | None = None


@dataclasses.dataclass(frozen=True)
class Params:
    """Scene configuration (reference: main.c:57-71).

    ``length``/``width``/``height``/``simulation_time`` carry float32-rounded
    values (C stores them in ``float``).  ``spatial_step``/``time_step`` are
    double.
    """

    length: float
    width: float
    height: float
    spatial_step: float
    time_step: float
    simulation_time: float
    sampling_rate: int
    mode: Mode
    # --- extensions over the reference ---
    dtype: str = "float32"  # field dtype: float32 | float64 | bfloat16
    source: SourceConfig = dataclasses.field(default_factory=SourceConfig)

    # Derived grid sizes (reference: main.c:237-239).
    @property
    def maxi(self) -> int:
        return int(self.length / self.spatial_step)

    @property
    def maxj(self) -> int:
        return int(self.width / self.spatial_step)

    @property
    def maxk(self) -> int:
        return int(self.height / self.spatial_step)

    @property
    def padded_shape(self) -> tuple[int, int, int]:
        """Uniform (k, j, i) array shape that holds every staggered component.

        All six Yee components live in arrays of this one shape; each
        component's *physical* region is a sub-box of it (see
        :mod:`fdtd_tpu.grid`).  Uniform shapes keep one sharding and let
        XLA fuse the component updates.
        """
        return (self.maxk + 1, self.maxj + 1, self.maxi + 1)

    @property
    def cell_count(self) -> int:
        return self.maxi * self.maxj * self.maxk

    def cfl_limit(self) -> float:
        """Taflove CFL bound on dt for a uniform cubic grid.

        c*dt <= (1/dx^2 + 1/dy^2 + 1/dz^2)^(-1/2)  (description.pdf section 3.1).
        """
        d = self.spatial_step
        return d / (CELERITY * math.sqrt(3.0))

    def is_cfl_stable(self) -> bool:
        return self.time_step <= self.cfl_limit()

    def validate(self) -> None:
        if self.time_step <= 0:
            # The reference hangs forever on dt <= 0 (main.c:765 never
            # terminates); here it is a clean error instead.
            raise ValueError("The time step must be positive!")
        if self.time_step > self.simulation_time:
            # Same sanity check as reference main.c:818-821.
            raise ValueError("The time step must be lower than the simulation time!")
        if min(self.maxi, self.maxj, self.maxk) < 2:
            raise ValueError("Grid too small: need at least 2 cells per axis")


def _c_float(tok: str) -> float:
    """Parse like C ``%f`` into float then promote (round through float32)."""
    return float(np.float32(tok))


def parse_params_text(text: str, **overrides) -> Params:
    """Parse the 8 ordered scalars of a params.txt (reference: main.c:226-233)."""
    toks: Sequence[str] = text.split()
    if len(toks) < 8:
        raise ValueError(f"params.txt needs 8 values, got {len(toks)}")
    p = Params(
        length=_c_float(toks[0]),
        width=_c_float(toks[1]),
        height=_c_float(toks[2]),
        spatial_step=float(toks[3]),
        time_step=float(toks[4]),
        simulation_time=_c_float(toks[5]),
        sampling_rate=int(toks[6]),
        mode=Mode(int(toks[7], 16)),  # %x quirk: mode parsed as hex (main.c:233)
        **overrides,
    )
    return p


def load_parameters(path: str, **overrides) -> Params:
    with open(path) as f:
        return parse_params_text(f.read(), **overrides)


def time_values(p: Params) -> np.ndarray:
    """Exact sequence of time_counter values of the reference loop.

    The C driver accumulates ``time_counter += time_step`` in double and runs
    while ``time_counter <= simulation_time`` (reference: main.c:765).  Python
    floats are C doubles, so this loop reproduces the iteration count and the
    per-step source phases bit-exactly.
    """
    ts = []
    t = 0.0
    limit = p.simulation_time
    while t <= limit:
        ts.append(t)
        t += p.time_step
    return np.asarray(ts, dtype=np.float64)


def num_steps(p: Params) -> int:
    return len(time_values(p))
