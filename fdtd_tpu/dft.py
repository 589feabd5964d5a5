"""On-the-fly DFT of the E field: steady-state phasors without storage.

Frequency-domain diagnostics the reference workflow can only fake by
dumping every snapshot and post-processing: accumulate

    E_hat(f) = (2/N) * sum_n E(t_n) * exp(-i 2 pi f t_n)

per cell *during* the time loop (running sums — no time series is ever
stored), yielding the complex steady-state field pattern at the drive
(or any) frequency, its magnitude map, and the cycle-averaged CW power
deposition  q_cw = 1/2 sigma |E_hat|^2  that a SAR accumulation only
approaches after many periods of transient averaging.

The quadrature weights cos/sin(2 pi f t_n) are host-precomputed in fp64
(same discipline as the source's drive_values: on-device fp32 phase at
~1e2 rad would cost ~1e-5 rad resolution, and x64 is off in production)
and ride the scan as per-step inputs; the accumulators are fp32 and add
one fused multiply-add sweep of the three cell-centered E components
per step.  Normalization: for a real signal A cos(2 pi f t + phi)
sampled over whole periods, |E_hat| -> A (the 2/N factor), so phasor
magnitudes read directly in field units.

Every path that carries per-step states accumulates it: the closed
cavity, CPML, dispersive and sharded scans all call
:func:`fdtd_tpu.monitors.apply_monitors`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .params import Params


@dataclasses.dataclass(frozen=True)
class DftConfig:
    """Frequencies (Hz) to accumulate; phasors at cell centers.

    ``fields``: "e" (Ex, Ey, Ez — the default) or "eh" (all six
    components, enabling the cycle-averaged complex Poynting vector
    S = 1/2 Re(E x H*) — the radiated-power-density map)."""

    frequencies: tuple
    fields: str = "e"

    def __post_init__(self):
        fs = tuple(float(f) for f in self.frequencies)
        if not fs:
            raise ValueError("DFT needs at least one frequency")
        if any(f <= 0 for f in fs):
            raise ValueError("DFT frequencies must be positive Hz")
        object.__setattr__(self, "frequencies", fs)
        if self.fields not in ("e", "eh"):
            raise ValueError("DFT fields must be 'e' or 'eh'")

    @property
    def nf(self) -> int:
        return len(self.frequencies)

    @property
    def nc(self) -> int:
        return 6 if self.fields == "eh" else 3


def dft_weights(dft: DftConfig, times) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) weight arrays of shape (n_steps, nf), fp64 phase math
    on host, fp32 storage (they scale fp32 fields)."""
    t = np.asarray(times, np.float64)[:, None]
    f = np.asarray(dft.frequencies, np.float64)[None, :]
    ph = 2.0 * np.pi * f * t
    return (np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32))


def zero_dft_acc(p: Params, dft: DftConfig):
    """(re, im) accumulators, shape (nf, nc, maxk, maxj, maxi) fp32 —
    component order (Ex, Ey, Ez[, Hx, Hy, Hz]) at cell centers."""
    shape = (dft.nf, dft.nc, p.maxk, p.maxj, p.maxi)
    return jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)


def accumulate(p: Params, cells, cw, sw, acc):
    """One step of the running sums: acc_re += cos * F, acc_im -= sin * F
    (so re + i*im = sum F exp(-i w t)).  ``cells``: the nc cell-mean
    arrays; ``cw``/``sw``: (nf,) weights for this step."""
    re, im = acc
    E = jnp.stack([c.astype(jnp.float32) for c in cells])[None]  # (1,nc,...)
    cw = cw[:, None, None, None, None]
    sw = sw[:, None, None, None, None]
    return re + cw * E, im - sw * E


@dataclasses.dataclass
class DftResult:
    frequencies: tuple
    # complex phasors (nf, nc, maxk, maxj, maxi): (2/N)-normalized so a
    # steady A*cos(2 pi f t + phi) component reads |.| = A; components
    # 3:6 (when fields="eh") carry the leapfrog half-step phase
    # correction (see finalize)
    phasors: np.ndarray
    steps: int
    fields: str = "e"

    def magnitude(self, fi: int = 0) -> np.ndarray:
        """|E| magnitude map (sqrt of the sum over E components) at
        frequency index ``fi``."""
        ph = self.phasors[fi, :3]
        return np.sqrt((np.abs(ph) ** 2).sum(axis=0))

    def cw_power(self, sigma_cells, fi: int = 0) -> np.ndarray:
        """Cycle-averaged CW power deposition 1/2 sigma |E_hat|^2 (W/m^3)
        at frequency index ``fi`` — the steady-state heating map a --sar
        accumulation approaches after many periods."""
        ph = self.phasors[fi, :3]
        return 0.5 * np.asarray(sigma_cells) * (np.abs(ph) ** 2).sum(axis=0)

    def poynting(self, fi: int = 0) -> np.ndarray:
        """Cycle-averaged Poynting vector S = 1/2 Re(E x H*) (W/m^2),
        shape (3, maxk, maxj, maxi) — needs fields="eh".  Standing modes
        (E and H in time quadrature) read ~0; traveling/radiated power
        reads the net energy-flux density."""
        if self.fields != "eh":
            raise ValueError("Poynting needs DftConfig(fields='eh')")
        E = self.phasors[fi, :3]
        H = np.conj(self.phasors[fi, 3:])
        return 0.5 * np.real(np.cross(E, H, axis=0))


def finalize(dft: DftConfig, acc, steps: int,
             time_step: float | None = None) -> DftResult:
    """Apply the 2/N amplitude normalization and assemble the result.

    With fields="eh", the H phasors get the leapfrog half-step phase
    correction: the post-step H samples live at t_n - dt/2 while the
    weights use t_n, so H_true = H_meas * exp(+i w dt/2).  Without it a
    standing mode's cycle-averaged Poynting leaks ~sin(w dt/2) of the
    |E||H| scale instead of reading zero."""
    re, im = acc
    scale = 2.0 / max(steps, 1)
    phasors = (np.asarray(re, np.float64)
               + 1j * np.asarray(im, np.float64)) * scale
    if dft.fields == "eh":
        if time_step is None:
            raise ValueError("fields='eh' finalize needs time_step")
        w = 2.0 * np.pi * np.asarray(dft.frequencies)
        corr = np.exp(0.5j * w * time_step)[:, None, None, None, None]
        phasors[:, 3:] = phasors[:, 3:] * corr
    return DftResult(
        frequencies=dft.frequencies, phasors=phasors, steps=steps,
        fields=dft.fields,
    )

