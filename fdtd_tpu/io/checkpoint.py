"""Checkpoint / resume.

The reference's Silo dumps are write-only visualization artifacts
(reference: main.c:550-598); here snapshots double as restart points: the
full staggered state plus the step index round-trips losslessly through an
.npz, and the CLI can resume a long run from the latest checkpoint
(SURVEY section 5, checkpoint/resume row).
"""

from __future__ import annotations

import glob
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np

from ..params import Params
from ..state import FieldState

_FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")


def save_checkpoint(
    path: str,
    state: FieldState,
    iteration: int,
    t: float,
    power: jnp.ndarray | np.ndarray | None = None,
    aux: dict | None = None,
) -> None:
    """``aux``: extra named arrays (e.g. the CPML psi memory variables),
    stored under ``aux_<name>`` keys; see :func:`load_aux`."""
    arrays = {name: np.asarray(getattr(state, name)) for name in _FIELDS}
    if power is not None:
        arrays["power_acc"] = np.asarray(power)
    for name, a in (aux or {}).items():
        arrays[f"aux_{name}"] = np.asarray(a)
    tmp = path + ".tmp.npz"
    np.savez(tmp, iteration=np.int64(iteration), t=np.float64(t), **arrays)
    os.replace(tmp, path)


def load_checkpoint(
    path: str, p: Params
) -> tuple[FieldState, int, float, jnp.ndarray | None]:
    with np.load(path) as z:
        arrays = {}
        for name in _FIELDS:
            a = z[name]
            if a.shape != p.padded_shape:
                raise ValueError(
                    f"checkpoint {name} shape {a.shape} != params shape {p.padded_shape}"
                )
            arrays[name] = jnp.asarray(a, dtype=jnp.dtype(p.dtype))
        power = jnp.asarray(z["power_acc"]) if "power_acc" in z else None
        return FieldState(**arrays), int(z["iteration"]), float(z["t"]), power


def load_aux(path: str) -> dict:
    """The ``aux_<name>`` arrays of a checkpoint as ``{name: ndarray}``
    (empty for checkpoints written without aux state)."""
    with np.load(path) as z:
        return {k[4:]: z[k] for k in z.files if k.startswith("aux_")}


class CheckpointWriter:
    """Asynchronous checkpoint writer (same pattern as SnapshotWriter).

    A 1024^3 bf16 state is a ~13 GB .npz; writing it inline stalls the step
    loop for the whole device->host copy + encode (the round-2 review's
    "synchronous checkpointing" finding).  ``submit`` only captures the jax
    arrays (dispatch is async) and hands them to a single background worker
    that performs the transfer and the crash-safe tmp-rename write; the step
    loop continues immediately.  At most one checkpoint is in flight — a
    second ``submit`` first drains the previous one (bounding host RAM at
    one extra state copy), and ``close`` drains everything.

    Crash safety is unchanged from :func:`save_checkpoint`: the worker
    writes ``path + ".tmp.npz"`` then ``os.replace``s it, and
    :func:`latest_checkpoint` never picks up ``*.tmp.npz`` leftovers.
    """

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight: Future | None = None

    def submit(self, state: FieldState, iteration: int, t: float, power=None,
               aux: dict | None = None) -> None:
        self.drain()
        path = os.path.join(self.out_dir, f"ckpt{iteration:06d}.npz")
        # Device->host on the main thread, in order with the step loop's
        # dispatches; the worker keeps the npz encode + disk write, which
        # dominate checkpoint cost.
        import jax as _jax

        state_h = _jax.tree.map(np.asarray, state)
        power_h = None if power is None else np.asarray(power)
        aux_h = None if aux is None else {k: np.asarray(v) for k, v in aux.items()}
        self._inflight = self._pool.submit(
            save_checkpoint, path, state_h, iteration, t, power_h, aux_h
        )

    def drain(self) -> None:
        """Wait for (and surface errors from) the in-flight write, if any."""
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def close(self) -> None:
        self.drain()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def latest_checkpoint(out_dir: str) -> str | None:
    # strict ckpt(\d+).npz$ match: excludes partial "*.tmp.npz" files left
    # by a crash mid-save, which would otherwise be picked up and fail to load
    pat = re.compile(r"ckpt(\d+)\.npz$")
    cands = [
        (int(m.group(1)), f)
        for f in glob.glob(os.path.join(out_dir, "ckpt[0-9]*.npz"))
        if (m := pat.search(os.path.basename(f)))
    ]
    return max(cands)[1] if cands else None
