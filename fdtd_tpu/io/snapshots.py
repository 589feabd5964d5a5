"""Snapshot assembly and asynchronous host streaming.

The reference pays a fully serial Silo write per sample — the documented
scaling killer (description.pdf section 5: output-inclusive speedup ~1).
Here the cell-centered aggregation runs on device (fused by XLA), and the
device->host copy + file encode run on a background thread pool so the step
loop never stalls: the main thread only enqueues jax arrays (dispatch is
async) and moves on.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import numpy as np

from .. import analytic, grid
from ..params import Mode, Params
from ..state import FieldState
from .vtr import write_vtr


def aggregate_all(p: Params, s: FieldState) -> dict[str, jax.Array]:
    """Zone-centered variables with the reference's names and semantics
    (reference: main.c:563-579)."""
    return {
        "ex": grid.aggregate_e(p, s.ex, "ex"),
        "ey": grid.aggregate_e(p, s.ey, "ey"),
        "ez": grid.aggregate_e(p, s.ez, "ez"),
        "hx": grid.aggregate_h(p, s.hx, "hx"),
        "hy": grid.aggregate_h(p, s.hy, "hy"),
        "hz": grid.aggregate_h(p, s.hz, "hz"),
    }


def validation_extras(
    p: Params, s: FieldState, t: float, quirk_compat: bool = True
) -> dict[str, jax.Array]:
    """aEy/aHx/aHz zone-centered variables (reference: main.c:581-589).

    With ``quirk_compat`` (default), replicates the reference bug where
    aHx/aHz aggregate the *computed* Hx/Hz instead of the error fields
    (main.c:585-588), and uses the C-compat analytic formulas; otherwise
    exports true (physics-correct analytic - computed) error fields for all
    three components.
    """
    err = analytic.error_fields(p, s, t, ccompat=quirk_compat)
    a_ey = grid.aggregate_e(p, err["aEy"], "ey")
    if quirk_compat:
        a_hx = grid.aggregate_h(p, s.hx, "hx")
        a_hz = grid.aggregate_h(p, s.hz, "hz")
    else:
        a_hx = grid.aggregate_h(p, err["aHx"], "hx")
        a_hz = grid.aggregate_h(p, err["aHz"], "hz")
    return {"aEy": a_ey, "aHx": a_hx, "aHz": a_hz}


class SnapshotWriter:
    """Double-buffered async .vtr writer.

    ``submit`` is non-blocking: it captures device arrays (XLA dispatch is
    already async) and hands them to a worker thread that performs the
    device->host transfer and the file write.  ``close`` drains the queue.
    A bounded number of in-flight snapshots (2) applies gentle backpressure
    so device memory isn't filled with retired snapshot copies.
    """

    def __init__(self, p: Params, out_dir: str, pattern: str = "result%04d.vtr"):
        self.p = p
        self.out_dir = out_dir
        self.pattern = pattern
        self.coords = grid.node_coords(p)
        os.makedirs(out_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._inflight: list[Future] = []
        self._series: list[tuple[float, str]] = []  # (time, filename)

    def submit(self, variables: dict[str, jax.Array], iteration: int, t: float = 0.0) -> None:
        # Backpressure: keep at most 2 snapshots in flight.
        while len(self._inflight) >= 2:
            self._inflight.pop(0).result()
        fname = self.pattern % iteration
        path = os.path.join(self.out_dir, fname)
        self._series.append((t, fname))
        # The device->host transfer happens HERE, on the main thread, in
        # order with the step loop's dispatches.  The expensive part that
        # stays async is the encode + file write.
        host = {k: np.asarray(v) for k, v in variables.items()}
        self._inflight.append(self._pool.submit(self._write, path, host))

    def _write(self, path: str, host: dict[str, np.ndarray]) -> None:
        from .native import write_vtr_native

        if not write_vtr_native(path, self.coords, host):
            write_vtr(path, self.coords, host)

    def close(self) -> None:
        for f in self._inflight:
            f.result()
        self._inflight.clear()
        self._pool.shutdown(wait=True)
        self._write_series_index()

    def _write_series_index(self) -> None:
        """ParaView .pvd catalog: the snapshot series with physical times —
        the VisIt/ParaView time-series workflow the reference got from Silo
        file numbering."""
        if not self._series:
            return
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">',
            "  <Collection>",
        ]
        for t, fname in self._series:
            lines.append(f'    <DataSet timestep="{t!r}" group="" part="0" file="{fname}"/>')
        lines += ["  </Collection>", "</VTKFile>", ""]
        with open(os.path.join(self.out_dir, "series.pvd"), "w") as f:
            f.write("\n".join(lines))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
