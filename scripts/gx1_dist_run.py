"""gx1 (1-degree, 320x384x60) distributed factor + solve on a simulated
8-device mesh — the rebuild's equivalent of the reference's production
run (144 MPI ranks on Cheyenne, test/test_solve_ABglobal.csh:6-7,31).

Run:
    XLA_FLAGS="--xla_force_host_platform_device_count=8 \
        --xla_cpu_collective_timeout_seconds=7200 \
        --xla_cpu_collective_call_warn_stuck_timeout_seconds=3600 \
        --xla_cpu_collective_call_terminate_timeout_seconds=7200" \
        python scripts/gx1_dist_run.py

The raised collective timeouts matter: XLA:CPU's in-process rendezvous
kills the process after 40 s by default, and on a single core
time-sharing 8 virtual devices the per-device compute between
collectives at this scale far exceeds that (a simulated-environment
artifact — on real hardware the devices run concurrently).

Float64 factors by default (NK_RUN_PREC=f32 for float32), host-side
float64 iterative refinement. Memory: ~144 GB of float64 padded factors
(~72 GB in float32) sharded over the mesh, inside the host's RAM. On virtual devices all 8 shards share one core, so the
wall-clock here measures correctness and memory behavior, not speed.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    if os.environ.get("NK_RUN_CPU", "1") != "0":
        # simulated mesh: pin the CPU before first device use (XLA_FLAGS
        # sets the device count when the CPU backend is created)
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ndev = len(jax.devices())
    print(f"devices: {ndev}", flush=True)
    if ndev < 2:
        print("need a multi-device mesh: run with XLA_FLAGS="
              "--xla_force_host_platform_device_count=8", flush=True)
        return 2

    from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.api import (
        iterative_refinement)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.checkpoint import (
        load_symbolic, save_symbolic)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
        MultifrontalFactorization)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    from nk_ocn_tracer_jacobian_precond_tpu.utils import set_dbg_lvl

    set_dbg_lvl(1)
    cache = os.path.join(os.path.dirname(__file__), "..", ".bench_cache")
    size = os.environ.get("NK_RUN_SIZE", "gx1")
    mat = os.path.join(cache, f"matrix_{size}.nc")
    t0 = time.perf_counter()
    matrix = read_matrix_file(mat)
    maps = load_ind_maps(mat)
    print(f"load {time.perf_counter()-t0:.1f}s flat_len={matrix.flat_len} "
          f"nnz={matrix.nnz}", flush=True)

    sym_ck = os.path.join(cache, f"sym_{size}.npz")
    t0 = time.perf_counter()
    if os.path.exists(sym_ck):
        sym = load_symbolic(sym_ck)
    else:
        sym = symbolic_from_matrix(maps, matrix, leaf_size=16)
        save_symbolic(sym_ck, sym)
    print(f"symbolic {time.perf_counter()-t0:.1f}s", flush=True)

    import jax.numpy as jnp
    t0 = time.perf_counter()
    # per-round factor checkpointing: the run resumes across process
    # restarts / session budgets (the round-1 gx1 run died at round
    # ~120/160 and lost everything)
    ckpt_dir = os.environ.get("NK_RUN_CKPT",
                              os.path.join(cache, f"fckpt_{size}"))
    # f64 factors are the production default here: the 60-level trees'
    # measured elimination growth makes eps32 x growth O(1) — the fp32
    # round-2 gx1 factor set solved to raw residual 1.1e4, unusable even
    # as a GMRES preconditioner. NK_RUN_PREC=f32 keeps the old behavior
    # for comparison runs.
    prec = (jnp.float32 if os.environ.get("NK_RUN_PREC", "f64") == "f32"
            else jnp.float64)
    # production refinement target = the residual contract (1e-10);
    # round 4 measured a ~5e-11 plateau, so a 1e-11 target only buys
    # wasted refinement outers (VERDICT round-4 item 5)
    rtol = float(os.environ.get("NK_REFINE_TOL", "1e-10"))
    fac = MultifrontalFactorization(matrix, impl="jax", maps=maps, sym=sym,
                                    n_devices=ndev, precision=prec,
                                    refine_tol=rtol,
                                    factor_checkpoint_dir=ckpt_dir or None)
    t_factor = time.perf_counter() - t0
    print(f"distributed factor {t_factor:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    nrhs = 2
    B = rng.standard_normal((matrix.flat_len, nrhs))
    t0 = time.perf_counter()
    X = fac.solve(B, refine=False)
    t_solve = time.perf_counter() - t0
    print(f"solve (no refine) {t_solve:.1f}s", flush=True)

    t0 = time.perf_counter()
    X = iterative_refinement(fac.A, fac._precond_solve, B, X, tol=rtol)
    rel = np.linalg.norm(fac.A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    if rel.max() > 1e-10:
        # float32 element growth stalls plain IR at depth: Krylov-
        # accelerated refinement with the distributed solve as the
        # preconditioner (the production path does this on device;
        # host scipy.gmres here keeps the one compiled program small
        # on the simulated mesh)
        print(f"plain IR stalled at {rel.max():.3e}; GMRES-IR", flush=True)
        X = fac._gmres_ir(B, X)
        X = iterative_refinement(fac.A, fac._precond_solve, B, X, tol=rtol)
        rel = (np.linalg.norm(fac.A @ X - B, axis=0)
               / np.linalg.norm(B, axis=0))
    t_ref = time.perf_counter() - t0
    print(f"refine {t_ref:.1f}s residuals {rel}", flush=True)
    ok = bool(rel.max() <= 1e-10)
    print(f"{size} distributed: ok={ok} max_rel={rel.max():.3e} "
          f"factor={t_factor:.1f}s solve={t_solve:.1f}s refine={t_ref:.1f}s",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
