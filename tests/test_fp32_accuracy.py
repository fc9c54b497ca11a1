"""The float32 accuracy story at depth (SURVEY §7 hard part #2).

The float32 configuration is float32 factors + float64 device refinement
(GMRES-IR when element growth stalls plain refinement — measured growth is
~1e7 at gx3, which makes the raw float32 solve useless on its own). These
tests force that exact configuration on CPU for a 60-level (gx3deep-class
water-column depth) problem and assert the refined solve still reaches
direct-solver accuracy.
"""

import numpy as np
import pytest

import jax

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions, PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file


@pytest.fixture(scope="module")
def deep_problem(tmp_path_factory):
    d = tmp_path_factory.mktemp("deep")
    circ = str(d / "circ.nc")
    # 60 levels — the gx3deep/gx1 water-column depth; modest horizontal
    # extent keeps the CPU factorization in CI budget
    make_circ_file(circ, imt=24, jmt=20, km=60, seed=17)
    mat = str(d / "matrix.nc")
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    opts = AssemblyOptions(circ_fname=circ, hmix_type="isop_file",
                           vmix_type="file", per_tracer=[pt])
    run_gen_a(mat, opts=opts)
    return read_matrix_file(mat), load_ind_maps(mat)


def test_fp32_factor_refined_to_1e10_at_depth(deep_problem):
    import jax.numpy as jnp
    matrix, maps = deep_problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                   refine_tol=1e-11)
    # force the float32 factor regime (the default is float64)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
        JaxMultifrontal)
    mf.engine = JaxMultifrontal(mf.sym, _scaled(mf), precision=jnp.float32)
    mf._refiner = None          # rebuild the refiner against the f32 engine
    rng = np.random.default_rng(9)
    B = rng.standard_normal((matrix.flat_len, 3))
    X = mf.solve(B)
    A = matrix.to_scipy()
    rel = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() <= 1e-10, f"fp32+refine at depth: {rel}"


def _scaled(mf):
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import equilibrate
    scaled, _, _ = equilibrate(mf.matrix)
    return scaled


def test_fp32_raw_vs_refined_gap_documented(deep_problem):
    """The raw fp32 solve is expected to be orders of magnitude worse than
    the refined one — this pins the mechanism (if the raw solve were
    already at 1e-10, the refiner would be dead code; if the refined one
    degraded, the accuracy story broke)."""
    import jax.numpy as jnp
    matrix, maps = deep_problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                   refine_tol=1e-11)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
        JaxMultifrontal)
    mf.engine = JaxMultifrontal(mf.sym, _scaled(mf), precision=jnp.float32)
    mf._refiner = None
    rng = np.random.default_rng(10)
    B = rng.standard_normal((matrix.flat_len, 2))
    A = matrix.to_scipy()
    X_raw = mf._precond_solve(B)
    rel_raw = np.linalg.norm(A @ X_raw - B, axis=0) / np.linalg.norm(B, axis=0)
    X = mf.solve(B)
    rel = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() <= 1e-10
    # raw fp32 must be no better than ~1e-5 relative (fp32 eps * growth);
    # the refined result must beat it by many orders
    assert rel_raw.max() > rel.max() * 10


def test_compensated_spmv_beats_plain_f32(deep_problem):
    """_spmv_comp (double-float32 Dekker products, f64 accumulation) must
    reproduce the exact f64 SpMV to ~1e-13 relative — the property that
    lets the fused device loop use device-side outer residuals without
    the emulated-f64-multiply floor. Plain f32 SpMV sits at ~1e-7."""
    import jax.numpy as jnp
    matrix, maps = deep_problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                   refine_tol=1e-11)
    ref = mf._device_refiner()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((matrix.flat_len, 2))
    env = ref._env()
    y_exact = matrix.to_scipy() @ x
    scale = np.abs(y_exact).max()
    y_comp = np.asarray(ref._spmv_comp(env, jnp.asarray(x)))
    y_f32 = np.asarray(ref._spmv(env, jnp.asarray(x, dtype=jnp.float32)))
    err_comp = np.abs(y_comp - y_exact).max() / scale
    err_f32 = np.abs(y_f32 - y_exact).max() / scale
    assert err_comp < 1e-12, err_comp
    assert err_comp < 1e-4 * err_f32, (err_comp, err_f32)
