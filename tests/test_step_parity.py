"""Bit-level (fp64) parity of the jitted step against the loop oracle."""

import dataclasses

import jax
import numpy as np
import pytest

from fdtd_tpu.params import Mode, time_values
from fdtd_tpu.state import init_validation, zeros
from fdtd_tpu.step import make_step, scan_inputs

from .oracle import OracleSim

COMPONENTS = ["ex", "ey", "ez", "hx", "hy", "hz"]


def _assert_states_close(state, oracle, atol=0.0, rtol=0.0):
    for name in COMPONENTS:
        got = np.asarray(getattr(state, name))
        want = getattr(oracle, name)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)


def test_validation_mode_parity_fp64(tiny_params):
    p = tiny_params
    state = init_validation(p)
    oracle = OracleSim(p)
    oracle.set_initial_te101()
    # np.sin vs math.sin may differ by ~1 ulp
    _assert_states_close(state, oracle, atol=1e-15, rtol=1e-13)

    step = jax.jit(make_step(p))
    ts, amps = scan_inputs(p, time_values(p)[:12])
    for t, a in zip(ts, amps):
        state = step(state, (t, a))
        oracle.step(t, computation=False)
    # identical operation order in fp64 -> tight tolerance (not bitwise only
    # because XLA may reassociate the two curl subtractions)
    _assert_states_close(state, oracle, atol=1e-15, rtol=1e-11)


def test_computation_mode_parity_fp64(tiny_params):
    p = dataclasses.replace(tiny_params, mode=Mode.COMPUTATION)
    state = zeros(p)
    oracle = OracleSim(p)

    step = jax.jit(make_step(p))
    ts, amps = scan_inputs(p, time_values(p)[:12])
    for t, a in zip(ts, amps):
        state = step(state, (t, a))
        oracle.step(t, computation=True)
    _assert_states_close(state, oracle, atol=1e-15, rtol=1e-11)


def test_fp32_vs_fp64_drift_small(tiny_params):
    p64 = tiny_params
    p32 = dataclasses.replace(tiny_params, dtype="float32")
    s64 = init_validation(p64)
    s32 = init_validation(p32)
    step64 = jax.jit(make_step(p64))
    step32 = jax.jit(make_step(p32))
    ts, amps = scan_inputs(p64, time_values(p64)[:20])
    for t, a in zip(ts, amps):
        s64 = step64(s64, (t, a))
        s32 = step32(s32, (t, a))
    # L2 over all components well below the 1e-5 north-star bar
    num = sum(float(((np.asarray(getattr(s32, c), np.float64) - np.asarray(getattr(s64, c))) ** 2).sum()) for c in COMPONENTS)
    den = sum(float((np.asarray(getattr(s64, c)) ** 2).sum()) for c in COMPONENTS)
    assert (num / den) ** 0.5 < 1e-5


def test_pec_boundary_invariant(tiny_params):
    """Tangential E on the six faces must stay exactly zero (PEC)."""
    p = tiny_params
    state = init_validation(p)
    step = jax.jit(make_step(p))
    ts, amps = scan_inputs(p, time_values(p)[:10])
    for t, a in zip(ts, amps):
        state = step(state, (t, a))
    K, J, I = p.maxk, p.maxj, p.maxi
    ex, ey, ez = (np.asarray(state.ex), np.asarray(state.ey), np.asarray(state.ez))
    # Ex tangential on j=0, j=J, k=0, k=K faces
    assert np.all(ex[0, :, :I] == ex[0, :, :I] * 0) or np.allclose(ex[0], 0)
    assert np.allclose(ex[K], 0) and np.allclose(ex[:, 0], 0) and np.allclose(ex[:, J], 0)
    # Ez tangential on i=0, i=I, j=0, j=J faces
    assert np.allclose(ez[:, :, 0], 0) and np.allclose(ez[:, :, I], 0)
    assert np.allclose(ez[:, 0, :], 0) and np.allclose(ez[:, J, :], 0)
    # Ey tangential on i=0, i=I, k=0, k=K faces: equals its (frozen) initial value
    ey0 = np.asarray(init_validation(p).ey)
    assert np.allclose(ey[:, :, 0], ey0[:, :, 0]) and np.allclose(ey[:, :, I], ey0[:, :, I])
    assert np.allclose(ey[0], ey0[0]) and np.allclose(ey[K], ey0[K])


def _cube(n, mode, dtype):
    from fdtd_tpu.params import Params

    dx = 0.001
    return Params(
        length=n * dx, width=n * dx, height=n * dx, spatial_step=dx,
        time_step=1e-12, simulation_time=20e-12, sampling_rate=10**9,
        mode=Mode(mode), dtype=dtype,
    )


# fp32 holds the north-star 1e-5 bar against the fp64 oracle.  bf16 stores
# 8 mantissa bits (one ulp is 3.9e-3 relative) and rounds every step.
_ORACLE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("n", [12, 13, 16])
def test_jnp_step_matches_oracle(n, mode, dtype):
    """The jitted jnp step (the one path every run takes) against the
    triple-loop fp64 oracle, on even and odd grids, both modes, both
    storage dtypes."""
    p = _cube(n, mode, dtype)
    state = init_validation(p) if mode == 0 else zeros(p)
    oracle = OracleSim(p)
    if mode == 0:
        oracle.set_initial_te101()
    step = jax.jit(make_step(p))
    ts, amps = scan_inputs(p, time_values(p)[:8])
    for t, a in zip(ts, amps):
        state = step(state, (t, a))
        oracle.step(t, computation=mode == 1)
    assert state.ex.dtype == np.dtype(dtype)
    num = den = 0.0
    for c in COMPONENTS:
        got = np.asarray(getattr(state, c), np.float64)
        want = getattr(oracle, c)
        num += float(((got - want) ** 2).sum())
        den += float((want**2).sum())
    assert den > 0
    assert (num / den) ** 0.5 < _ORACLE_TOL[dtype]
