"""Memory-plan accounting vs the engine's actual factor allocations."""

import numpy as np
import pytest

import jax

from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import run_gen_a
from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import read_matrix_file
from nk_ocn_tracer_jacobian_precond_tpu.ops import (
    AssemblyOptions, PerTracerOptions)
from nk_ocn_tracer_jacobian_precond_tpu.solver.memplan import plan_memory
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
    MultifrontalFactorization)
from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    d = tmp_path_factory.mktemp("memplan")
    circ = str(d / "circ.nc")
    make_circ_file(circ, imt=24, jmt=20, km=6, seed=2)
    mat = str(d / "matrix.nc")
    opts = AssemblyOptions(
        circ_fname=circ, hmix_type="isop_file", vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1e-4)])
    run_gen_a(mat, opts=opts)
    return read_matrix_file(mat), load_ind_maps(mat)


def test_factor_bytes_match_engine_allocations(problem):
    matrix, maps = problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    eng = mf.engine
    itemsize = np.dtype(eng.prec).itemsize
    mp = plan_memory(eng.plans, n_devices=1, bytes_per_elem=itemsize)
    actual = 0
    for K, U12, L21, perm, KD in eng.factors:
        actual += (K.size + U12.size + L21.size) * itemsize + perm.size * 4
        if KD is not None:
            actual += KD.size * itemsize
    assert actual == mp.factor_bytes_total
    assert mp.factor_bytes_per_device == mp.factor_bytes_total
    assert mp.peak_per_device >= mp.factor_bytes_total


def test_sharding_reduces_per_device_bytes(problem):
    matrix, maps = problem
    mf = MultifrontalFactorization(matrix, impl="jax", maps=maps)
    eng = mf.engine
    mp1 = plan_memory(eng.plans, n_devices=1)
    mp8 = plan_memory(eng.plans, n_devices=8)
    assert mp8.factor_bytes_per_device < mp1.factor_bytes_per_device
    assert mp8.factor_bytes_total == mp1.factor_bytes_total
    # every round whose batch divides the mesh is counted sharded
    for r1, r8 in zip(mp1.rounds, mp8.rounds):
        if r8["B"] % 8 == 0:
            assert r8["factor_dev"] == r1["factor_dev"] // 8
        else:
            assert r8["factor_dev"] == r1["factor_dev"]


def test_pf_temp_bound_covers_compiled_programs(problem):
    """memplan's envelope for the partial factor's XLA temporaries must
    cover what this backend's compiler actually allocates, round by
    round (the compiled memory analysis of the engine's own program)."""
    import jax.numpy as jnp

    from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
    from nk_ocn_tracer_jacobian_precond_tpu.solver.memplan import (
        pf_temp_bytes)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    matrix, maps = problem
    plans = mf_jax.build_plan(symbolic_from_matrix(maps, matrix), matrix)
    for plan in plans:
        F = jax.ShapeDtypeStruct((plan.B, plan.N, plan.N), jnp.float64)
        p_arr = jax.ShapeDtypeStruct((plan.B,), jnp.int32)
        native = plan.B <= 2
        with jax.default_matmul_precision("highest"):
            c = mf_jax._partial_factor.lower(
                F, P=plan.P, p_arr=p_arr, tau=1e-8,
                allow_native_lu=native).compile()
        temp = c.memory_analysis().temp_size_in_bytes
        assert temp <= pf_temp_bytes(plan.B, plan.P, plan.N, 8, native), (
            plan.B, plan.P, plan.N)


@pytest.mark.parametrize("n_devices", [1, 8])
def test_peak_holds_partial_factor_working_set(problem, n_devices):
    """Every round's high-water mark covers the partial-factor phase:
    earlier rounds' factors, the input front, the temporaries and the
    round's own outputs (factors + Schur stack)."""
    from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
    from nk_ocn_tracer_jacobian_precond_tpu.solver.memplan import (
        pf_temp_bytes)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    matrix, maps = problem
    plans = mf_jax.build_plan(symbolic_from_matrix(maps, matrix), matrix,
                              batch_multiple=n_devices)
    mp = plan_memory(plans, n_devices=n_devices, bytes_per_elem=8)
    fac_before = 0
    for plan, r in zip(plans, mp.rounds):
        front = plan.B * plan.N * plan.N * 8
        temp = pf_temp_bytes(plan.B, plan.P, plan.N, 8,
                             native_lu=plan.B <= 2 and n_devices == 1)
        assert r["transient"] >= front + temp
        assert r["highwater"] >= (fac_before + front + temp + r["factor"]
                                  + plan.B * plan.M * plan.M * 8)
        fac_before += r["factor"]
    assert mp.peak_per_device == max(r["highwater_dev"] for r in mp.rounds)
