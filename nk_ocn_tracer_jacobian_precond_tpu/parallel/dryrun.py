"""Multi-chip dry run: the FULL distributed preconditioner workflow on an
n-device mesh, executable on a single host via XLA's simulated devices.

Exercises everything the distributed mode (the reference's solve_ABdist,
src/solve_ABdist.c:422-612) does, on tiny shapes:

  1. assemble a Jacobian, factor it with the front batches sharded over
     the mesh (distributed multifrontal — the pdgstrf replacement),
  2. run the level-wave triangular solves for a multi-RHS batch,
  3. refine with the latitude-band-sharded stencil SpMV (ppermute halo
     rings — the pdgsrfs replacement),
  4. cross-check the distributed solution against scipy's SuperLU.

Run as a module in a clean process (jax must not have initialized yet):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m nk_ocn_tracer_jacobian_precond_tpu.parallel.dryrun 8
"""

from __future__ import annotations

import sys

import numpy as np


def run(n_devices: int) -> None:
    import jax

    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} devices, jax sees {len(jax.devices())}"
            " — run in a fresh process with XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n_devices}")

    from ..io.matrixfile import SparseMatrix
    from ..ops.assemble import to_csr
    from ..solver.mf import MultifrontalFactorization
    from .demo import make_demo_assembly
    from .mesh import make_mesh
    from .stencil import StencilOperator

    def build(**opt_kw):
        asm, maps = make_demo_assembly(imt=16, jmt=16, km=4, **opt_kw)
        nzval, colind, rowptr = to_csr(asm)
        return asm, maps, SparseMatrix(nzval=nzval, colind=colind,
                                       rowptr=rowptr,
                                       coupled_tracer_cnt=asm.nt)

    # --- distributed factor + level-wave triangular solves ----------------
    # PRIMARY: a gen_a-assembled transport Jacobian of the production
    # option class (centered advection + IRF hmix + file vmix — what the
    # reference's own workflow factors) must meet the 1e-10 workflow
    # contract OUTRIGHT, not relative to SuperLU.
    asm, maps, matrix = build(hmix_type="isop_file")
    fac = MultifrontalFactorization(matrix, impl="jax", maps=maps,
                                    n_devices=n_devices)
    eng = fac.engine
    assert eng.mesh is not None
    sharded = eng.sharded_rounds()
    assert sharded >= 1, "no factor round ended up sharded over the mesh"

    rng = np.random.default_rng(0)
    B = rng.standard_normal((matrix.flat_len, 3))
    X = fac.solve(B)
    A = matrix.to_scipy()
    rel = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    contract = 1e-10 if jax.config.jax_enable_x64 else 1e-6
    assert rel.max() <= contract, \
        f"distributed residual {rel.max():.3e} misses the " \
        f"{contract:.0e} workflow contract"

    # SECONDARY: a deliberately ill-conditioned synthetic (upwind3 +
    # random IRF — the widest stencil); here the bar is SuperLU's own
    # achieved residual on the same system, as in the reference.
    asm2, maps2, matrix2 = build(adv_type="upwind3", hmix_type="isop_file")
    # refine_tol sits safely BELOW the assert bar's floor (the bar is
    # max(floor, 10*SuperLU) below): a tolerance at the bar itself could
    # stop the refiner above a SuperLU-achieved residual under 1e-10 and
    # fail spuriously. 1e-11 < floor keeps the refiner honest while
    # avoiding the default 1e-13 target's stall warnings on a system
    # whose conditioning caps BOTH solvers near 1e-9 (the explicit
    # SuperLU-relative assert below is the real check).
    fac2 = MultifrontalFactorization(matrix2, impl="jax", maps=maps2,
                                     n_devices=n_devices, refine_tol=1e-11)
    B2 = rng.standard_normal((matrix2.flat_len, 3))
    import warnings as _warnings
    with _warnings.catch_warnings(record=True) as caught:
        _warnings.simplefilter("always")
        X2 = fac2.solve(B2)
    for w in caught:
        # a refinement stall on this case is conditioning, not a solver
        # defect — surface it as an explained line, asserted against the
        # SuperLU-relative bar below, not as a bare warning in the artifact
        print(f"dryrun secondary (conditioning-limited by design, "
              f"SuperLU-relative bar applies): {w.message}")
    A2 = matrix2.to_scipy()
    from scipy.sparse.linalg import splu
    X2_ref = splu(A2.tocsc()).solve(B2)
    rel2 = np.linalg.norm(A2 @ X2 - B2, axis=0) / np.linalg.norm(B2, axis=0)
    rel2_ref = (np.linalg.norm(A2 @ X2_ref - B2, axis=0)
                / np.linalg.norm(B2, axis=0))
    floor = 1e-10 if jax.config.jax_enable_x64 else 1e-7
    bar = max(floor, 10.0 * rel2_ref.max())
    assert rel2.max() <= bar, \
        f"ill-conditioned residual {rel2.max():.3e} vs SuperLU " \
        f"{rel2_ref.max():.3e}"

    # --- sharded stencil SpMV (the refinement operator) -------------------
    op = StencilOperator.from_assembly(asm)
    mesh = make_mesh(n_devices, ("band",))
    apply_fn, sharding, pad_field, unpad_field = op.sharded_apply_factory(mesh)
    km, jmt, imt = op.shape
    wet = np.arange(km)[:, None, None] < np.asarray(asm.grid.KMT)[None]
    x3 = np.where(wet, rng.standard_normal((km, jmt, imt)), 0.0)[None]
    x3 = np.repeat(x3, op.nt, axis=0)
    y_sh = unpad_field(apply_fn(jax.device_put(pad_field(x3), sharding)))
    import jax.numpy as jnp
    y_loc = np.asarray(op._device_copy().apply(jnp.asarray(x3)))
    scale = max(np.abs(y_loc).max(), 1.0)
    assert np.allclose(y_sh, y_loc, rtol=1e-5, atol=1e-6 * scale), \
        "sharded stencil SpMV mismatch"

    # --- scaled case: the production gx1 code paths -----------------------
    # (VERDICT round-3 item 9) Force, at dryrun-affordable size, exactly
    # the mechanisms the 1-degree production run uses and the toy demo
    # above cannot reach:
    #   * multi-chunk rounds (NK_MEM_BUDGET forces the chunker to split),
    #   * front-axis (row-)sharded tree-top factors + the masked
    #     substitution path (ROW_SHARD_MIN lowered so the scaled tree-top
    #     qualifies at this size),
    #   * the streamed-rounds out-of-core path: factor-only pass writing
    #     per-round checkpoints, then solver/stream_solve.py over them.
    import os as _os
    import tempfile as _tempfile

    from ..solver.checkpoint import load_symbolic, save_symbolic
    from ..solver.mf import equilibrate
    from ..solver.mf_jax import JaxMultifrontal, build_plan
    from ..solver.stream_solve import stream_solve
    from ..solver.symbolic import symbolic_from_matrix

    import jax.numpy as jnp3

    asm3, maps3 = make_demo_assembly(imt=32, jmt=24, km=12,
                                     hmix_type="isop_file")
    nz3, ci3, rp3 = to_csr(asm3)
    matrix3 = SparseMatrix(nzval=nz3, colind=ci3, rowptr=rp3,
                           coupled_tracer_cnt=asm3.nt)
    sym3 = symbolic_from_matrix(maps3, matrix3, leaf_size=16)
    plans_default = build_plan(sym3, matrix3, batch_multiple=n_devices)
    old_env = _os.environ.get("NK_MEM_BUDGET")
    old_min = JaxMultifrontal.ROW_SHARD_MIN
    try:
        _os.environ["NK_MEM_BUDGET"] = "2e6"     # ~2 MB: forces chunking
        JaxMultifrontal.ROW_SHARD_MIN = 256
        fac3 = MultifrontalFactorization(matrix3, impl="jax", maps=maps3,
                                         sym=sym3, n_devices=n_devices)
        eng3 = fac3.engine
        assert len(eng3.plans) > len(plans_default), \
            "NK_MEM_BUDGET did not force multi-chunk rounds " \
            f"({len(eng3.plans)} vs {len(plans_default)} plans)"
        rowsh = [i for i, p in enumerate(eng3.plans)
                 if eng3._row_sharded(p)]
        masked = [i for i in rowsh if eng3.factors[i][4] is not None]
        assert rowsh, "no front-axis (row-)sharded round at scaled size"
        assert masked, "no round took the masked-substitution (KD) path"
        B3 = rng.standard_normal((matrix3.flat_len, 3))
        X3 = fac3.solve(B3)
        A3 = matrix3.to_scipy()
        rel3 = (np.linalg.norm(A3 @ X3 - B3, axis=0)
                / np.linalg.norm(B3, axis=0))
        assert rel3.max() <= contract, \
            f"scaled front-sharded residual {rel3.max():.3e}"

        # streamed-rounds path: factor-only checkpoint pass (single
        # engine, offload on) followed by the out-of-core stream solve —
        # the exact split the gx1 production run uses
        ckdir = _tempfile.mkdtemp(prefix="nk_dryrun_fckpt_")
        fm3, _, _ = equilibrate(matrix3)
        prec3 = jnp3.float64 if jax.config.jax_enable_x64 else None
        eng_f = JaxMultifrontal(sym3, fm3, precision=prec3,
                                checkpoint_dir=ckdir, factor_only=True)
        X3s, rel3s = stream_solve(matrix3, maps3, sym3, ckdir, B3,
                                  pack_bs=eng_f._pack_bs)
        assert rel3s.max() <= contract, \
            f"streamed-rounds residual {rel3s.max():.3e}"
        import shutil
        shutil.rmtree(ckdir, ignore_errors=True)
    finally:
        JaxMultifrontal.ROW_SHARD_MIN = old_min
        if old_env is None:
            _os.environ.pop("NK_MEM_BUDGET", None)
        else:
            _os.environ["NK_MEM_BUDGET"] = old_env

    print(f"dryrun ok: {n_devices} devices, {sharded} sharded factor "
          f"rounds, transport-matrix residual {rel.max():.3e} <= "
          f"{contract:.0e} contract; ill-conditioned secondary "
          f"{rel2.max():.3e} (SuperLU on same system: {rel2_ref.max():.3e}); "
          f"scaled case: {len(eng3.plans)} chunked rounds "
          f"({len(plans_default)} default), {len(rowsh)} row-sharded, "
          f"{len(masked)} masked-substitution, front-sharded residual "
          f"{rel3.max():.3e}, streamed-rounds residual {rel3s.max():.3e}")


def main(argv=None) -> int:
    n = int((argv or sys.argv[1:])[0]) if (argv or sys.argv[1:]) else 8
    run(n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
