"""Distributed multifrontal solver tests on the simulated 8-device CPU
mesh (conftest.py sets --xla_force_host_platform_device_count=8).

This is the rebuild's test for the solve_ABdist capability: the numeric
factorization and triangular solves sharded over a device mesh must match
the single-device engine, and the per-device factor storage must actually
drop (the whole point of the reference's distributed mode,
src/solve_ABdist.c:106-244). The reference could only test this on a real
MPI cluster (SURVEY.md §4).
"""

import numpy as np
import pytest

import jax

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions, PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.parallel import make_mesh
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file

IMT, JMT, KM = 24, 20, 6


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=IMT, jmt=JMT, km=KM, seed=11)
    mat = str(d / "matrix.nc")
    pt = PerTracerOptions(sink_type="const", sink_rate=1.21e-4)
    opts = AssemblyOptions(circ_fname=circ, hmix_type="isop_file",
                           vmix_type="file", per_tracer=[pt])
    run_gen_a(mat, opts=opts)
    return read_matrix_file(mat), load_ind_maps(mat)


def _n_dev():
    return len(jax.devices())


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_distributed_matches_single_device(problem):
    matrix, maps = problem
    mf_1 = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    mf_8 = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                     sym=mf_1.sym, n_devices=8)
    rng = np.random.default_rng(5)
    B = rng.standard_normal((matrix.flat_len, 3))
    X1 = mf_1.solve(B)
    X8 = mf_8.solve(B)
    np.testing.assert_allclose(X8, X1, rtol=1e-10, atol=1e-12)
    A = matrix.to_scipy()
    rel = np.linalg.norm(A @ X8 - B, axis=0) / np.linalg.norm(B, axis=0)
    assert rel.max() < 1e-11


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_distributed_factors_are_sharded(problem):
    """The big rounds' factor stacks must live sharded over the mesh —
    per-device bytes for those rounds ~ 1/n_devices of the total."""
    matrix, maps = problem
    mesh = make_mesh(8, ("front",))
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps, mesh=mesh)
    eng = mf.engine
    sharded_rounds = 0
    for plan, (K, U12, L21, perm, KD) in zip(eng.plans, eng.factors):
        if plan.B % 8 == 0:
            # sharded over the front axis: each device holds B/8 fronts
            assert not K.sharding.is_fully_replicated, plan.B
            assert K.sharding.shard_shape(K.shape)[0] == plan.B // 8
            assert U12.sharding.shard_shape(U12.shape)[0] == plan.B // 8
            sharded_rounds += 1
    assert sharded_rounds >= 1


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_n_devices_flag_fails_loudly_when_unavailable(problem):
    matrix, maps = problem
    with pytest.raises(ValueError, match="devices"):
        MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                  n_devices=64)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_row_sharded_big_fronts_match_single_device(problem):
    """Tree-top rounds with fewer fronts than devices must shard their
    factor arrays along the front axes (the SuperLU 2-D-distribution
    analog for one supernode) and still solve identically."""
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
        JaxMultifrontal)
    matrix, maps = problem
    mf_1 = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    old = JaxMultifrontal.ROW_SHARD_MIN
    JaxMultifrontal.ROW_SHARD_MIN = 64   # the test grid's fronts are small
    try:
        mf_8 = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                         sym=mf_1.sym, n_devices=8)
        eng = mf_8.engine
        row_sharded = 0
        for plan, (K, U12, L21, perm, KD) in zip(eng.plans, eng.factors):
            if eng._row_sharded(plan):
                # K columns and U12 border axis each shard when divisible
                any_sharded = False
                if plan.P % 8 == 0:
                    assert not K.sharding.is_fully_replicated, (plan.B,
                                                                plan.P)
                    assert K.sharding.shard_shape(K.shape)[2] == plan.P // 8
                    assert KD is not None  # masked substitution engaged
                    any_sharded = True
                if plan.M and plan.M % 8 == 0:
                    assert not U12.sharding.is_fully_replicated
                    assert (U12.sharding.shard_shape(U12.shape)[2]
                            == plan.M // 8)
                    any_sharded = True
                if any_sharded:
                    row_sharded += 1
        assert row_sharded >= 1, "no round exercised row sharding"
        rng = np.random.default_rng(7)
        B = rng.standard_normal((matrix.flat_len, 3))
        X8 = mf_8.solve(B)
        X1 = mf_1.solve(B)
        np.testing.assert_allclose(X8, X1, rtol=1e-9, atol=1e-11)
    finally:
        JaxMultifrontal.ROW_SHARD_MIN = old


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_distributed_coupled_tracers(tmp_path):
    """2-tracer coupled systems (PO4/DOP-style cross-blocks) through the
    mesh-sharded factorization."""
    circ = str(tmp_path / "circ.nc")
    make_circ_file(circ, imt=16, jmt=14, km=5, seed=3)
    mat = str(tmp_path / "matrix.nc")
    pts = [PerTracerOptions(sink_type="const", sink_rate=1e-4),
           PerTracerOptions(sink_type="const", sink_rate=2e-4)]
    opts = AssemblyOptions(circ_fname=circ, hmix_type="const",
                           vmix_type="const", coupled_tracer_cnt=2,
                           per_tracer=pts,
                           coupled_tracer_type="OCMIP_BGC_PO4_DOP")
    run_gen_a(mat, opts=opts)
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    assert matrix.coupled_tracer_cnt == 2
    mf_1 = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    mf_8 = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                     sym=mf_1.sym, n_devices=8)
    rng = np.random.default_rng(9)
    B = rng.standard_normal((matrix.flat_len, 2))
    X1 = mf_1.solve(B)
    X8 = mf_8.solve(B)
    np.testing.assert_allclose(X8, X1, rtol=1e-9, atol=1e-11)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_memplan_matches_mesh_shard_sizes(problem):
    """plan_memory's per-device factor bytes must equal the sum of the
    engine's ACTUAL per-device shard sizes under the mesh."""
    from nk_ocn_tracer_jacobian_precond_tpu.solver.memplan import plan_memory
    matrix, maps = problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                   n_devices=8)
    eng = mf.engine
    itemsize = np.dtype(eng.prec).itemsize
    mp = plan_memory(eng.plans, n_devices=8, bytes_per_elem=itemsize)
    actual_dev = 0
    for K, U12, L21, perm, KD in eng.factors:
        arrs = [(K, itemsize), (U12, itemsize), (L21, itemsize), (perm, 4)]
        if KD is not None:
            arrs.append((KD, itemsize))
        for arr, isz in arrs:
            if arr.size == 0:
                continue
            shp = arr.sharding.shard_shape(arr.shape)
            actual_dev += int(np.prod(shp)) * isz
    assert actual_dev == mp.factor_bytes_per_device


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_rhs_axis_data_parallel_solve(problem):
    """A 2-axis ("front", "rhs") mesh: RHS batches shard data-parallel
    across device groups (the device-mesh get_B_dist) while fronts shard
    within a group — results must match the single-device engine."""
    matrix, maps = problem
    mf_1 = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    mf_r = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                     sym=mf_1.sym, n_devices=8,
                                     rhs_devices=2)
    assert "rhs" in mf_r.engine.mesh.axis_names
    assert mf_r.engine.mesh.shape["rhs"] == 2
    rng = np.random.default_rng(21)
    B = rng.standard_normal((matrix.flat_len, 4))   # 4 rhs / 2 groups
    X1 = mf_1.solve(B)
    Xr = mf_r.solve(B)
    np.testing.assert_allclose(Xr, X1, rtol=1e-9, atol=1e-11)
