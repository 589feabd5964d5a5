"""The one dispatch: every accepted single-device flag combination runs
the jnp step; the removed kernel tier names and flags are refused; the
compile-cache rule."""

import os

import pytest

from .dispatch_combos import combo_id, combos, run_combo

REMOVED = ("pallas", "pallas_fused", "pallas_temporal", "pallas_stream")
PARAMS_TEXT = "0.008 0.008 0.008 0.001 1e-12 3e-12 10 1"


@pytest.mark.parametrize("combo", combos(sharded=False), ids=combo_id)
def test_dispatch_runs_every_combination(combo):
    run_combo(combo)


@pytest.mark.parametrize("name", REMOVED)
def test_cli_refuses_removed_backend(name, tmp_path, capsys):
    from fdtd_tpu.cli import main

    params = tmp_path / "p.txt"
    params.write_text(PARAMS_TEXT)
    with pytest.raises(SystemExit) as exc:
        main([str(params), "--backend", name, "--no-output"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "removed kernel tier" in err and name in err


@pytest.mark.parametrize("name", REMOVED)
def test_run_simulation_refuses_removed_backend(name, tiny_params):
    from fdtd_tpu.runner import run_simulation

    with pytest.raises(ValueError, match="removed kernel tier"):
        run_simulation(tiny_params, write_snapshots=False, backend=name,
                       log=lambda s: None)


@pytest.mark.parametrize("name", ["auto", "xla"])
def test_cli_accepts_jnp_backend_names(name, tmp_path):
    from fdtd_tpu.cli import main

    params = tmp_path / "p.txt"
    params.write_text(PARAMS_TEXT)
    assert main([str(params), "--backend", name, "--no-output"]) == 0


def test_compile_cache_dir_follows_env(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and the helper hands
    JAX no other."""
    import jax

    from fdtd_tpu import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.compile_cache_dir() == str(tmp_path / "cc")
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cc")
    assert seen["jax_compilation_cache_dir"] == str(tmp_path / "cc")


def test_compile_cache_dir_defaults_to_repo(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR unset: <repo>/.jax_cache, which
    .gitignore lists."""
    from fdtd_tpu import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    assert compile_cache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) \
        == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
