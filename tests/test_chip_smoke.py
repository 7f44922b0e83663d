"""chip_smoke.py rehearsed on the CPU at a tiny size, and the compile-cache
helper it shares with the other scripts.

The phases run here exactly as on the GPU, on a 32-element cylinder; only
the device phase (which demands a GPU) is checked for refusing the CPU."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke
from nekstab_next_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = chip_smoke.Sizes(
    mesh=dict(nr=4, ntheta=8, order=5, outer_radius=10.0, grading=4.0),
    nsteps=5,
    quick_mesh=dict(nr=4, ntheta=8, order=4, outer_radius=10.0, grading=4.0),
    quick_nsteps=3,
    settle=10,
    newton_kdim=6,
    eig_kdim=8,
    multi_nsteps=3,
)


@pytest.fixture(scope="module")
def pipe():
    p = chip_smoke.Pipeline(TINY)
    yield p
    p.close()


@pytest.mark.parametrize("phase", ["step", "tangent", "mixed", "analysis",
                                   "multi"])
def test_phase_at_tiny_size(pipe, phase):
    if phase == "multi":
        # the 4-card path on four of the suite's virtual CPU devices
        chip_smoke.phase_multi(TINY, n_cards=4)
    else:
        chip_smoke.PHASES[phase](pipe)


@pytest.mark.gpu
def test_phases_on_the_gpu(gpu, pipe):
    # the same tiny phases on the card: the tangent phase then compares the
    # GPU with the CPU backend of the same process
    for phase in chip_smoke.PHASES.values():
        phase(pipe)


def test_device_phase_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_helper_honours_env(monkeypatch, tmp_path, cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_helper_default_is_fixed(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = os.path.join(REPO, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == expected
    assert compile_cache.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected
