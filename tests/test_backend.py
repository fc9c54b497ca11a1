"""The one backend decision (utils/backend.py) and what hangs off it:
the platform helper, the float64 default, the compile-cache placement,
and chip_smoke.py refusing to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
from nk_ocn_tracer_jacobian_precond_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_platform_known(name, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert backend.platform() == name


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_platform_rejects_unknown(name, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.platform()


def test_platform_here_is_cpu():
    assert backend.platform() == "cpu"      # conftest pins the CPU


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_env_var_is_honoured(cache_config, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert backend.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the code sets nothing
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_default_is_in_checkout(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    assert backend.setup_compile_cache() == backend.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == backend.DEFAULT_CACHE_DIR
    assert backend.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_cache_keeps_a_chosen_directory(cache_config, monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert backend.setup_compile_cache() == str(tmp_path)


def test_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert ".jax_cache/" in ignored


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
    from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu.ops import (
        AssemblyOptions, PerTracerOptions)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
    d = tmp_path_factory.mktemp("backend")
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=12, jmt=10, km=5, seed=4)
    mat = str(d / "m.nc")
    run_gen_a(mat, opts=AssemblyOptions(
        circ_fname=circ, hmix_type="isop_file", vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1e-4)]))
    matrix, maps = read_matrix_file(mat), load_ind_maps(mat)
    return mat, matrix, symbolic_from_matrix(maps, matrix, leaf_size=8)


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_engine_defaults_to_float64(tiny, name, monkeypatch):
    """precision=None gives float64 factors on every platform and solves
    to the float64 apply accuracy."""
    _, matrix, sym = tiny
    monkeypatch.setattr(mf_jax, "platform", lambda: name)
    eng = mf_jax.JaxMultifrontal(sym, matrix)
    assert eng.prec == jnp.float64
    assert eng.platform == name
    b = np.random.default_rng(0).standard_normal(matrix.flat_len)
    x = eng.solve(b)
    A = matrix.to_scipy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-9


def test_engine_float32_without_x64(tiny):
    _, matrix, sym = tiny
    jax.config.update("jax_enable_x64", False)
    try:
        eng = mf_jax.JaxMultifrontal(sym, matrix, factorize=False)
        assert eng.prec == jnp.float32
    finally:
        jax.config.update("jax_enable_x64", True)


def test_memplan_sizes_float64(tiny, capsys):
    from nk_ocn_tracer_jacobian_precond_tpu.drivers.solve import main
    mat, _, _ = tiny
    assert main(["--memplan", mat]) == 0
    out = capsys.readouterr().out
    assert "float64 factors" in out


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
