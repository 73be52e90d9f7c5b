"""Process-level rules: the compile-cache location, the native library's
source-hash key, and the one-card-per-process environment of workers."""

import os
import subprocess
import sys

import pytest

from bsmap_jax import default_cache_dir, REPO_DIR
from bsmap_jax import native
from bsmap_jax.parallel.distributed import (CARD_MEM_SHARE, visible_cards,
                                            worker_env)

from .conftest import REPO

_PRINT_CACHE = ("import bsmap_jax, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir_of(env) -> str:
    r = subprocess.run([sys.executable, "-c", _PRINT_CACHE], env=env,
                       cwd=REPO, capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[-1]


def _base_env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               BSMAP_JAX_CPU_JIT_CACHE="1")
    env.update(kw)
    return env


def test_cache_env_var_wins(tmp_path):
    assert _cache_dir_of(_base_env(
        JAX_COMPILATION_CACHE_DIR=str(tmp_path))) == str(tmp_path)


def test_cache_default_is_one_checkout_path(tmp_path):
    a = _cache_dir_of(_base_env())
    b = _cache_dir_of(_base_env(TMPDIR=str(tmp_path)))
    assert a == b == default_cache_dir(_base_env())
    assert a.startswith(os.path.join(REPO_DIR, ".jax_cache"))


@pytest.mark.parametrize("env,want", [
    ({"JAX_PLATFORMS": "cpu"}, None),
    ({"JAX_PLATFORMS": "cuda"}, ".jax_cache"),
    ({}, ".jax_cache"),
])
def test_default_cache_dir(env, want):
    got = default_cache_dir(env)
    assert got == (None if want is None else os.path.join(REPO_DIR, want))


def test_native_lib_keyed_on_source_hash(tmp_path):
    src = tmp_path / "bsmap_native.cpp"
    src.write_text("int f() { return 1; }\n")
    a = native.so_path(str(src))
    assert native.so_path(str(src)) == a
    src.write_text("int f() { return 2; }\n")
    b = native.so_path(str(src))
    assert a != b and os.path.dirname(a) == str(tmp_path)


def test_native_lib_loaded_is_current_source():
    lib = native.get_lib()
    assert lib is not None
    assert os.path.basename(lib._name) == os.path.basename(native.so_path())


@pytest.mark.parametrize("n,cards,want", [
    (2, ["0"], [("0", 0.45), ("0", 0.45)]),
    (4, ["0", "1", "2", "3"], [(c, 0.9) for c in "0123"]),
    (3, ["0", "1"], [("0", 0.45), ("1", 0.9), ("0", 0.45)]),
    (2, ["5", "7"], [("5", 0.9), ("7", 0.9)]),
])
def test_worker_env_one_card_each(n, cards, want):
    base = {"PATH": "/bin"}
    got = [worker_env(base, k, n, cards) for k in range(n)]
    assert [(e["CUDA_VISIBLE_DEVICES"],
             float(e["XLA_PYTHON_CLIENT_MEM_FRACTION"])) for e in got] == \
        [(c, pytest.approx(f)) for c, f in want]
    assert all(e["PATH"] == "/bin" for e in got)
    assert base == {"PATH": "/bin"}            # pure: input untouched
    assert CARD_MEM_SHARE == 0.9


def test_worker_env_keeps_set_fraction_and_cpu():
    env = worker_env({"XLA_PYTHON_CLIENT_MEM_FRACTION": "0.3"}, 1, 2, ["0"])
    assert env["XLA_PYTHON_CLIENT_MEM_FRACTION"] == "0.3"
    assert worker_env({"A": "1"}, 0, 2, []) == {"A": "1"}


def test_visible_cards(tmp_path):
    gpus = tmp_path / "gpus"
    gpus.mkdir()
    for bus in ("0000:01:00.0", "0000:02:00.0"):
        (gpus / bus).mkdir()
    assert visible_cards({"JAX_PLATFORMS": "cpu"}, str(gpus)) == []
    assert visible_cards({"CUDA_VISIBLE_DEVICES": "2,3"}, str(gpus)) == \
        ["2", "3"]
    assert visible_cards({}, str(gpus)) == ["0", "1"]
    assert visible_cards({"JAX_PLATFORMS": "cuda"}, str(gpus)) == ["0", "1"]
