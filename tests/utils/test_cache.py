"""Persistent-compilation-cache placement (utils/cache.py)."""
import os
import pathlib
import subprocess
import sys

import jax

from densepoints.utils.cache import CHECKOUT_CACHE_DIR, enable_compilation_cache

ROOT = pathlib.Path(__file__).resolve().parents[2]
_PROBE = (
    "import jax; from densepoints.utils.cache import enable_compilation_cache;"
    "d = enable_compilation_cache();"
    "print(d); print(jax.config.jax_compilation_cache_dir)"
)


def _probe(env_update, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return out.stdout.split()


def test_respects_existing_cache_dir():
    # The test conftest already configured a cache dir; enabling again
    # must NOT clobber it (the user-set-value contract).
    current = jax.config.jax_compilation_cache_dir
    assert current  # conftest set it
    assert enable_compilation_cache() == current
    assert jax.config.jax_compilation_cache_dir == current


def test_disabled_by_env(monkeypatch):
    monkeypatch.setenv("DENSEPOINTS_NO_CACHE", "1")
    assert enable_compilation_cache() is None


def test_env_var_is_honoured(tmp_path):
    want = str(tmp_path / "cc")
    got = _probe(
        {"JAX_COMPILATION_CACHE_DIR": want}, drop=("DENSEPOINTS_NO_CACHE",)
    )
    assert got == [want, want]


def test_fallback_is_fixed_checkout_dir():
    drop = ("JAX_COMPILATION_CACHE_DIR", "DENSEPOINTS_NO_CACHE")
    first = _probe({}, drop=drop)
    second = _probe({}, drop=drop)
    want = str(ROOT / ".jax_cache")
    assert str(CHECKOUT_CACHE_DIR) == want
    assert first == second == [want, want]
    assert pathlib.Path(want).is_dir()
