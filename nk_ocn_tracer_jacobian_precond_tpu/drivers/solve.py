"""solve driver: factor the matrix once, solve per tracer variable in-place.

Rebuild of both reference solver executables in one program
(src/solve_ABglobal.c and src/solve_ABdist.c): read the matrix file,
factor once, then for each comma-separated variable group read the tracer
field(s) from the inout file, flatten via the index maps, solve, scatter
back preserving land values, and write in place. The reference's
replicated/distributed split (-n nprow[,npcol] process grid) maps to the
backend choice here: single-device or mesh-sharded factorization; -n is
accepted for CLI compatibility and sets the requested device count.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..grid.indmap import load_ind_maps
from ..io import fields, netcdf3
from ..io.matrixfile import read_matrix_file
from ..solver.api import factor, residual_norm
from ..utils import dbg, set_dbg_lvl, timed


def parse_var_groups(vars_arg: str, coupled_tracer_cnt: int) -> list[list[str]]:
    """Split the comma-separated -v list into groups of coupled_tracer_cnt
    (src/solve_ABglobal.c:370-388 consumes vars in groups)."""
    names = [v for v in vars_arg.split(",") if v]
    if len(names) % coupled_tracer_cnt:
        raise ValueError(
            f"number of vars ({len(names)}) not a multiple of "
            f"coupled_tracer_cnt ({coupled_tracer_cnt})")
    return [names[i:i + coupled_tracer_cnt]
            for i in range(0, len(names), coupled_tracer_cnt)]


def run_solve(matrix_fname: str, inout_fname: str, vars_arg: str,
              backend: str = "auto", dbg_lvl: int = 0,
              check_residual: bool = True, n_devices: int | None = None,
              rhs_chunk: int = 32, rhs_devices: int = 1,
              factors_fname: str | None = None) -> dict:
    set_dbg_lvl(dbg_lvl)
    with timed("get_sparse_matrix"):
        matrix = read_matrix_file(matrix_fname)
    maps = load_ind_maps(matrix_fname)
    tsl = maps.tracer_state_len
    nt = matrix.coupled_tracer_cnt
    if matrix.flat_len != nt * tsl:
        raise ValueError("matrix flat_len inconsistent with index maps")

    groups = parse_var_groups(vars_arg, nt)

    kwargs = {}
    if backend != "scipy":
        kwargs["maps"] = maps
        if n_devices is not None:
            kwargs["n_devices"] = n_devices
        if rhs_devices > 1:
            kwargs["rhs_devices"] = rhs_devices
        if factors_fname is not None:
            kwargs["numeric_checkpoint"] = factors_fname
    with timed("factor"):
        fac = factor(matrix, backend=backend, **kwargs)

    # Solve RHS groups in bounded batches (multi-RHS amortization: the
    # reference loops one var at a time, ABglobal.c:370; batching is
    # strictly better on an accelerator). Staging is STREAMED rhs_chunk
    # groups at a time — the rebuild of get_B_dist/put_B_dist's bounded
    # per-rank RHS segments (solve_ABdist.c:248-418): host and device RHS
    # memory stay O(flat_len * rhs_chunk) however many tracer variables
    # the run covers, and each chunk is written back in place before the next is
    # read. Under a mesh with an "rhs" axis the chunk additionally shards
    # across device groups (parallel/mesh.py).
    results = {"residuals": {}, "groups": groups}
    hdr = netcdf3.read_header(inout_fname)
    chunk = max(1, rhs_chunk)
    for lo in range(0, len(groups), chunk):
        gchunk = groups[lo:lo + chunk]
        fields_3d = {}
        B = np.empty((matrix.flat_len, len(gchunk)))
        for g, group in enumerate(gchunk):
            for t, var in enumerate(group):
                dbg(1, f"reading {var} from {inout_fname}")
                f3 = fields.get_var_double(inout_fname, var, 3, hdr)
                fields_3d[var] = f3
                B[t * tsl:(t + 1) * tsl, g] = maps.flatten_field(f3)

        with timed("solve"):
            X = fac.solve(B)
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]

        for g, group in enumerate(gchunk):
            if check_residual:
                res = residual_norm(matrix, X[:, g], B[:, g])
                results["residuals"][",".join(group)] = res
                dbg(1, f"relative residual for {group}: {res:.3e}")
            for t, var in enumerate(group):
                f3 = maps.unflatten_into(fields_3d[var],
                                         X[t * tsl:(t + 1) * tsl, g])
                dbg(1, f"writing {var} to {inout_fname}")
                fields.put_var_inplace(inout_fname, var, f3)
    return results


def run_memplan(matrix_fname: str, n_devices: int, dbg_lvl: int = 0) -> int:
    """Pre-flight sizing: symbolic + round plan + exact padded-shape
    memory walk for the requested device count, no factorization. The
    reference had no way to size a job short of submitting it and
    watching SuperLU ABORT on allocation failure (solve_ABdist.c:147)."""
    set_dbg_lvl(dbg_lvl)
    matrix = read_matrix_file(matrix_fname)
    maps = load_ind_maps(matrix_fname)
    from ..solver.memplan import plan_memory
    from ..solver.mf_jax import build_plan
    from ..solver.symbolic import symbolic_from_matrix
    with timed("symbolic analysis"):
        sym = symbolic_from_matrix(maps, matrix)
    with timed("round plans"):
        plans = build_plan(sym, matrix, batch_multiple=n_devices)
    # size with the same precision rule the engine applies (float64
    # whenever x64 is enabled, mf_jax.JaxMultifrontal)
    import jax
    dtype_name, bytes_per_elem = (("float64", 8) if jax.config.jax_enable_x64
                                  else ("float32", 4))
    mp = plan_memory(plans, n_devices=n_devices,
                     bytes_per_elem=bytes_per_elem)
    gb = 1 / 2 ** 30
    print(f"matrix: flat_len={matrix.flat_len} nnz={matrix.nnz} "
          f"fronts={len(sym.fronts)} max_front={sym.max_front} "
          f"factor_flops={sym.factor_flops():.3e}")
    print(f"memory plan ({n_devices} device(s), {dtype_name} factors):")
    print(f"  factors resident: {mp.factor_bytes_total * gb:.2f} GB total, "
          f"{mp.factor_bytes_per_device * gb:.2f} GB/device")
    print(f"  Schur live peak:  {mp.schur_peak_per_device * gb:.2f} GB/device")
    print(f"  transient peak:   {mp.transient_peak_per_device * gb:.2f} GB/device")
    print(f"  peak per device:  {mp.peak_per_device * gb:.2f} GB")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="solve",
        description="solve the Jacobian preconditioner systems for tracer "
                    "variables, updating the inout file in place")
    p.add_argument("-D", dest="dbg_lvl", type=int, default=0)
    p.add_argument("-n", dest="npgrid", default=None,
                   help="nprow[,npcol] (reference compatibility; sets the "
                        "device count for the distributed backend)")
    p.add_argument("-v", dest="vars", default=None,
                   help="comma-separated tracer variable names")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "scipy", "multifrontal"])
    p.add_argument("--memplan", action="store_true",
                   help="print the per-device memory plan for this matrix "
                        "and device count, then exit (no factorization)")
    p.add_argument("--rhs-chunk", type=int, default=32,
                   help="stream tracer RHS groups through the solver this "
                        "many at a time (bounded staging, the get_B_dist "
                        "analog)")
    p.add_argument("--rhs-devices", type=int, default=1,
                   help="devices of the mesh to dedicate to an rhs "
                        "(data-parallel multi-RHS) axis")
    p.add_argument("--factors", dest="factors_fname", default=None,
                   help="numeric-factor checkpoint file: loaded (skipping "
                        "factorization) when it exists and matches this "
                        "matrix's values, else written after factoring — "
                        "the cross-run analog of the reference's "
                        "options.Fact=FACTORED reuse (multifrontal "
                        "backend only)")
    p.add_argument("matrix_fname")
    p.add_argument("inout_fname", nargs="?", default=None)
    args = p.parse_args(argv)
    if args.backend != "scipy":
        # entry-point scope (drivers own process-global config, the
        # library does not): float64 factors and residuals on device
        import jax

        from ..utils.backend import setup_compile_cache
        jax.config.update("jax_enable_x64", True)
        setup_compile_cache()
    n_devices = None
    if args.npgrid:
        parts = [int(x) for x in args.npgrid.split(",")]
        nprow = parts[0]
        npcol = parts[1] if len(parts) > 1 else nprow
        n_devices = nprow * npcol
    if args.memplan:
        return run_memplan(args.matrix_fname, n_devices or 1,
                           dbg_lvl=args.dbg_lvl)
    if not args.vars or args.inout_fname is None:
        print("solve: -v VARS and inout_fname are required (unless "
              "--memplan)", file=sys.stderr)
        return 2
    try:
        run_solve(args.matrix_fname, args.inout_fname, args.vars,
                  backend=args.backend, dbg_lvl=args.dbg_lvl,
                  n_devices=n_devices, rhs_chunk=args.rhs_chunk,
                  rhs_devices=args.rhs_devices,
                  factors_fname=args.factors_fname)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"solve: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
