"""Platform choices and process set-up: the compile-cache placement, the
per-platform choices of the decode machine, the synthesis recurrence and
the encode pack, and chip_smoke.py's refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from srla_tpu import kernels
from srla_tpu.encoder import SRLAEncoder
from srla_tpu.kernels import decode2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    return env


def _cache_dir_in_child(env) -> str:
    code = ("import jax, srla_tpu.kernels; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_from_environment(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache lands there and nothing
    else is configured in code."""
    want = str(tmp_path / "xla")
    assert _cache_dir_in_child(_cpu_env(JAX_COMPILATION_CACHE_DIR=want)) \
        == want


def test_cache_dir_fixed_in_checkout():
    """Unset: one fixed directory inside the checkout, listed in
    .gitignore, with XLA:CPU entries in a per-host subdirectory."""
    got = _cache_dir_in_child(_cpu_env())
    assert got == kernels.cache_dir_for("cpu")
    assert os.path.dirname(got) == kernels.CACHE_DIR == os.path.join(
        REPO, ".xla_cache")
    assert kernels.cache_dir_for("gpu") == kernels.CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".xla_cache/" in f.read().split()


@pytest.mark.parametrize("platform,unroll,lpc,pack", [
    ("gpu", True, "kernel", "scatter"),
    ("cpu", False, "scan", "scatter"),
])
def test_platform_choices(monkeypatch, platform, unroll, lpc, pack):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert decode2._unroll_bits_default() is unroll
    assert decode2._lpc_impl_default() == lpc
    assert SRLAEncoder._pack_impl() == pack


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """No GPU (and, alone, no repo beside the script): non-zero exit and no
    result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    env = _cpu_env()
    if alone:
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
