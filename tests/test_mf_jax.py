"""JAX multifrontal engine tests (simulated CPU devices, x64 enabled)."""

import numpy as np
import pytest

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import AssemblyOptions, PerTracerOptions
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import MultifrontalFactorization
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file

IMT, JMT, KM = 20, 16, 6


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    d = tmp_path_factory.mktemp("mfjax")
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=IMT, jmt=JMT, km=KM, seed=33)
    mat = str(d / "matrix.nc")
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    opts = AssemblyOptions(circ_fname=circ, hmix_type="isop_file",
                           vmix_type="file", per_tracer=[pt])
    run_gen_a(mat, opts=opts)
    return read_matrix_file(mat), load_ind_maps(mat)


def test_jax_engine_matches_numpy(problem):
    matrix, maps = problem
    mf_np = MultifrontalFactorization(matrix, impl="numpy", maps=maps)
    mf_jx = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                      sym=mf_np.sym)
    rng = np.random.default_rng(3)
    B = rng.standard_normal((matrix.flat_len, 2))
    X_np = mf_np.solve(B)
    X_jx = mf_jx.solve(B)
    np.testing.assert_allclose(X_jx, X_np, rtol=1e-9, atol=1e-12)


def test_jax_engine_residual(problem):
    matrix, maps = problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((matrix.flat_len, 4))
    X = mf.solve(B)
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res


def test_jax_engine_coupled_tracers(tmp_path):
    circ = str(tmp_path / "circ.nc")
    make_circ_file(circ, imt=12, jmt=10, km=4, seed=35)
    mat = str(tmp_path / "m.nc")
    pts = [PerTracerOptions(sink_type="const", sink_rate=2e-4),
           PerTracerOptions(sink_type="const", sink_rate=1e-4)]
    opts = AssemblyOptions(circ_fname=circ, hmix_type="const",
                           vmix_type="const", coupled_tracer_cnt=2,
                           per_tracer=pts,
                           coupled_tracer_type="OCMIP_BGC_PO4_DOP")
    run_gen_a(mat, opts=opts)
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps, leaf_size=6)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(matrix.flat_len)
    x = mf.solve(b)
    A = matrix.to_scipy()
    # 1e-10 is the workflow's accuracy target (BASELINE.md); this matrix's
    # conditioning puts scipy's SuperLU at ~1.2e-10 on the same system
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 1e-10


def test_ell_spill_assembly_path(problem, monkeypatch):
    """Force the hybrid assembly's SPILL branch (rows wider than the ELL
    width fall back to the unique-index scatter): cap the 98th-percentile
    width estimate at 4 so realistic isop rows (~15 entries) overflow,
    and check the factorization still reproduces the exact solve."""
    matrix, maps = problem
    from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
    real_quantile = np.quantile
    monkeypatch.setattr(
        mf_jax.np, "quantile",
        lambda a, q, **kw: min(real_quantile(a, q, **kw), 4.0))
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    # spills must actually exist for this test to mean anything
    assert any((p.a_pos < p.N * p.N).any() for p in mf.engine.plans)
    assert any(p.a_col.shape[2] == 4 for p in mf.engine.plans)
    rng = np.random.default_rng(7)
    B = rng.standard_normal((matrix.flat_len, 2))
    X = mf.solve(B)
    A = matrix.to_scipy()
    res = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-11, res


def test_assembly_matches_plan_oracle(problem):
    """_assemble on a real plan's biggest leaf chunk (ELL rows, spills,
    identity padding) must equal a numpy loop over the same plan arrays,
    bit for bit: every front entry receives at most one contribution."""
    import jax.numpy as jnp
    matrix, maps = problem
    from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    sym = symbolic_from_matrix(maps, matrix, leaf_size=16)
    plans = mf_jax.build_plan(sym, matrix)
    p = max(plans, key=lambda q: q.B)       # biggest leaf chunk
    nz = np.zeros(matrix.nnz + 1)
    nz[:-1] = matrix.nzval
    spill = bool((p.a_pos < p.N * p.N).any())
    F = np.asarray(mf_jax._assemble(
        jnp.asarray(nz), jnp.asarray(p.a_col), jnp.asarray(p.a_csrc),
        jnp.asarray(p.a_pos), jnp.asarray(p.a_src), jnp.asarray(p.p_arr),
        N=p.N, P=p.P, spill=spill))
    ref = np.zeros((p.B, p.N * p.N))
    rows = np.arange(p.a_col.shape[1])[:, None] * p.N
    for b in range(p.B):
        np.add.at(ref[b], (rows + p.a_col[b]).ravel(), nz[p.a_csrc[b]].ravel())
        real = p.a_pos[b] < p.N * p.N
        np.add.at(ref[b], p.a_pos[b][real], nz[p.a_src[b][real]])
    ref = ref.reshape(p.B, p.N, p.N)
    ar = np.arange(p.P)
    ref[:, ar, ar] += ar[None, :] >= p.p_arr[:, None]
    np.testing.assert_array_equal(F, ref)


def _dies_by_refcount(make):
    """Build objects with make() -> (owner, watched...), drop the owner
    with the cyclic garbage collector off, and report which watched
    objects are still alive. Device buffers freed only by the cyclic
    collector stay allocated for an unbounded time: a second
    factorization in the same process then runs out of device memory."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        owner, *watched = make()
        refs = [weakref.ref(w) for w in watched]
        del owner, watched
        return [r() is not None for r in refs]
    finally:
        gc.enable()


def test_facade_frees_factors_without_gc(problem):
    """The facade after a solve, a Newton refactor and a second solve
    holds its engine, factors and refiner in no reference cycle."""
    import jax
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import SparseMatrix
    matrix, maps = problem

    def make():
        fac = MultifrontalFactorization(matrix, impl="jax", maps=maps)
        B = np.random.default_rng(12).standard_normal((matrix.flat_len, 2))
        fac.solve(B)
        m2 = SparseMatrix(nzval=np.asarray(matrix.nzval) * 1.001,
                          colind=matrix.colind, rowptr=matrix.rowptr,
                          coupled_tracer_cnt=matrix.coupled_tracer_cnt)
        fac.refactor(m2)
        fac.solve(B)
        leaf = jax.tree_util.tree_leaves(fac.engine.factors)[0]
        return fac, fac.engine, fac._refiner, leaf

    assert _dies_by_refcount(make) == [False, False, False]


def test_refiner_krylov_programs_free_without_gc(problem):
    """With no host preconditioner the refiner compiles and caches its
    fused GMRES programs; those programs must not pin the refiner (and,
    through it, the engine's factors)."""
    import jax
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import equilibrate
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
        JaxMultifrontal)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.refine import (
        DeviceRefiner)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    matrix, maps = problem
    scaled, dr, dc = equilibrate(matrix)
    sym = symbolic_from_matrix(maps, matrix)

    def make():
        eng = JaxMultifrontal(sym, scaled)
        ref = DeviceRefiner(eng, matrix, dr=dr, dc=dc, tol=1e-12)
        B = np.random.default_rng(13).standard_normal((matrix.flat_len, 2))
        X = ref.solve(B)
        A = matrix.to_scipy()
        rel = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
        assert rel.max() < 1e-10, rel
        assert ref._fused_jit or ref._cycle_jit     # Krylov path ran
        leaf = jax.tree_util.tree_leaves(eng.factors)[0]
        return (eng, ref), eng, ref, leaf

    assert _dies_by_refcount(make) == [False, False, False]


def test_refactor_keeps_refiner_programs(problem):
    """Newton-iteration reuse: refactor() with new values on the same
    pattern must keep the DeviceRefiner instance (its compiled fused
    programs) and still converge — rebuilding it re-traced the fused
    refinement program every outer iteration."""
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import SparseMatrix
    matrix, maps = problem
    fac = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    rng = np.random.default_rng(11)
    B = rng.standard_normal((matrix.flat_len, 2))
    fac.solve(B)
    ref = getattr(fac, "_refiner", None)
    nz = np.asarray(matrix.nzval) * (
        1.0 + 1e-3 * rng.standard_normal(matrix.nnz))
    m2 = SparseMatrix(nzval=nz, colind=matrix.colind, rowptr=matrix.rowptr,
                      coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    fac.refactor(m2)
    X = fac.solve(B)
    if ref is not None:
        assert fac._refiner is ref
    A2 = m2.to_scipy()
    res = np.linalg.norm(A2 @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() < 1e-10, res
