#!/usr/bin/env python
"""On-card smoke test: the main path on one NVIDIA GPU in native float64.

    python chip_smoke.py            # one GPU: all phases below
    python chip_smoke.py --four     # four GPUs: the distributed solve only

Phases (one card):
  1. device   — JAX's first device is a GPU; no CPU fallback.
  2. kernels  — the factor path's kernels as compiled for the card, at
                gx3deep widths, against plain numpy references: _mm in
                float64 (relative error <= 1e-14: native DGEMM) and in
                float32 (<= 1e-5: no TF32), the pivoted panel loop
                (identical pivots, <= 1e-10), the extend-add (<= 1e-15:
                atomic-add order) and the assembly (bit-exact).
  3. main     — gen_a -> solve --memplan -> solve on gx3deep (100x116x60,
                synthetic circulation seed 7, 4 tracers) through the CLIs;
                the updated tracer file is read back with scipy's netCDF
                reader and every variable must meet ||Ax-b||/||b|| <= 1e-10
                in host float64, with land cells bit-identical.
  4. newton   — one Newton-reuse step through the facade: new values on
                the same pattern (ops/device_update.py), refactor, solve,
                same 1e-10 check.
With --four: gen_a, then `solve -n 4,1` on four cards, checked the same way
(the one-card run of the same seed prints the residuals to compare);
prints the sharded round count and every device's peak memory.

Any failure exits non-zero before the result line. The last line of
stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GRID = dict(imt=100, jmt=116, km=60)     # gx3deep
SEED = 7
TRACERS = ("IAGE_CUR", "PO4_CUR", "DIC_CUR", "ALK_CUR")
OPTS = ("adv_type centered\nhmix_type isop_file\nvmix_type file\n"
        "sink_type const 1.21e-4\n")
CONTRACT = 1e-10


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# -- phase 1 ---------------------------------------------------------------

def phase_device(n_cards: int):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform!r}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = smi.stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        raise Failed(f"nvidia-smi unavailable: {e}") from e
    check(smi.returncode == 0 and lines, "nvidia-smi gave no card")
    for line in lines:
        print(f"nvidia-smi: {line}", flush=True)
    log(f"device {devs[0].device_kind}, {len(devs)} visible")
    return devs


# -- phase 2 ---------------------------------------------------------------

def np_restricted_panel(Pan, off, p_arr, tau):
    """Right-looking LU of a (B, R, T) panel, pivots restricted to rows
    >= k that are fully summed (global row < p_arr[b]) or row k itself;
    pivots below tau in magnitude become sign * tau."""
    A = np.array(Pan, dtype=np.float64)
    B, R, T = A.shape
    piv = np.zeros((B, T), np.int64)
    rows = np.arange(R)
    for b in range(B):
        M = A[b]
        for k in range(T):
            ok = (rows >= k) & ((off + rows < p_arr[b]) | (rows == k))
            sel = int(np.argmax(np.where(ok, np.abs(M[:, k]), -1.0)))
            M[[k, sel]] = M[[sel, k]]
            piv[b, k] = sel
            if abs(M[k, k]) < tau:
                M[k, k] = -tau if M[k, k] < 0 else tau
            M[k + 1:, k] /= M[k, k]
            M[k + 1:, k + 1:] -= np.outer(M[k + 1:, k], M[k, k + 1:])
    return A, piv


def rel_err(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp

    from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
    rng = np.random.default_rng(SEED)

    # trailing Schur GEMMs: the tree-top round (one front, max front
    # 6,757 -> padded 6,784, panel width 128) and a batched mid-tree one
    for shape in ((1, 6656, 128, 6656), (64, 896, 128, 896)):
        B, M, K, N = shape
        a = rng.standard_normal((B, M, K))
        b = rng.standard_normal((B, K, N))
        e64 = rel_err(mf_jax._mm(jnp.asarray(a), jnp.asarray(b)),
                      np.matmul(a, b))
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        e32 = rel_err(mf_jax._mm(jnp.asarray(a32), jnp.asarray(b32)),
                      np.matmul(a32, b32).astype(np.float64))
        log(f"_mm {shape}: f64 rel err {e64:.2e} (<= 1e-14), "
            f"f32 HIGHEST rel err {e32:.2e} (<= 1e-5)")
        check(e64 <= 1e-14, f"_mm f64 {shape}: {e64:.3e}")
        check(e32 <= 1e-5, f"_mm f32 {shape}: {e32:.3e}")

    # pivoted panel loop (XLA column loop), restricted pivoting + tau
    B, R, T, off = 8, 1024, 128, 128
    Pan = rng.standard_normal((B, R, T))
    p_arr = np.linspace(off + 64, off + R, B).astype(np.int32)
    p_arr[0] = 0                          # one dummy identity front
    tau = 0.05
    ref, piv_ref = np_restricted_panel(Pan, off, p_arr, tau)
    out, piv = mf_jax._pivoted_panel(jnp.asarray(Pan), off,
                                     jnp.asarray(p_arr), tau)
    e = rel_err(out, ref)
    same = bool(np.array_equal(np.asarray(piv), piv_ref))
    # one-ulp FMA-contraction differences, amplified by element growth
    log(f"_pivoted_panel {(B, R, T)}: pivots identical={same}, "
        f"rel diff {e:.2e} (<= 1e-10)")
    check(same and e <= 1e-10, "pivoted panel disagrees with numpy")

    # extend-add against a numpy loop. Destinations with 3+ contributions
    # accumulate through atomic adds in no fixed order, so the bound is
    # rounding of the sum, not bit equality
    B, N, Msrc, Sb, L = 8, 1024, 768, 16, 12
    S = rng.standard_normal((Sb, Msrc, Msrc))
    ss = rng.integers(0, Sb, L).astype(np.int32)
    ds = rng.integers(0, B, L).astype(np.int32)
    ds[1] = ds[0]
    iv = rng.integers(0, Msrc + 1, (L, N)).astype(np.int32)
    Sp = np.pad(S, ((0, 0), (0, 1), (0, 1)))
    ref = np.zeros((B, N, N))
    for li in range(L):
        ref[ds[li]] += Sp[ss[li]][iv[li]][:, iv[li]]
    got = mf_jax._extend_add(jnp.zeros((B, N, N)), jnp.asarray(S),
                             jnp.asarray(ss), jnp.asarray(ds),
                             jnp.asarray(iv))
    e = rel_err(got, ref)
    log(f"_extend_add {(B, N, Msrc)}: rel err {e:.2e} (<= 1e-15)")
    check(e <= 1e-15, f"extend-add: {e:.3e}")

    # assembly against numpy (bit-exact)
    B, N, W, nnz = 8, 1024, 16, 200000
    nz = np.zeros(nnz + 1)
    nz[:nnz] = rng.standard_normal(nnz)
    a_col = np.stack([np.stack([np.sort(rng.choice(N, W, replace=False))
                                for _ in range(N)]) for _ in range(B)])
    a_col = a_col.astype(np.int32)
    a_csrc = rng.integers(0, nnz + 1, (B, N, W)).astype(np.int32)
    a_pos = np.tile(N * N + np.arange(4, dtype=np.int32), (B, 1))
    a_src = np.full((B, 4), nnz, np.int32)
    p_arr = np.full(B, N, np.int32)
    ref = np.zeros((B, N, N))
    for b in range(B):
        np.add.at(ref[b], (np.arange(N)[:, None], a_col[b]), nz[a_csrc[b]])
    args = tuple(map(jnp.asarray, (nz, a_col, a_csrc, a_pos, a_src, p_arr)))
    got = np.asarray(mf_jax._assemble(*args, N=N, P=N, spill=False))
    exact = bool(np.array_equal(got, ref))
    log(f"_assemble {(B, N, W)}: bit-exact={exact}")
    check(exact, "assembly is not bit-exact")


# -- phase 3: the CLIs -------------------------------------------------------

def run_cli(main, argv) -> str:
    """Run a CLI main() in this process (one process holds the card);
    echo and return what it printed to stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        if "refine outer" not in line:
            print(f"  | {line}", flush=True)
    check(rc == 0, f"{main.__module__} {' '.join(argv)} exited {rc}")
    return out


def make_problem(work: str) -> dict:
    from nk_ocn_tracer_jacobian_precond_tpu.drivers import gen_a
    from nk_ocn_tracer_jacobian_precond_tpu.testdata import (
        make_circ_file, make_tracer_file)
    p = dict(circ=os.path.join(work, "circ.nc"),
             opts=os.path.join(work, "opts.txt"),
             matrix=os.path.join(work, "matrix.nc"),
             tracer=os.path.join(work, "tracer.nc"),
             before=os.path.join(work, "tracer_before.nc"))
    t0 = time.perf_counter()
    make_circ_file(p["circ"], seed=SEED, **GRID)
    make_tracer_file(p["tracer"], GRID["imt"], GRID["jmt"], GRID["km"],
                     tracer_names=TRACERS, seed=SEED)
    shutil.copy(p["tracer"], p["before"])
    with open(p["opts"], "w") as f:
        f.write(f"circ_fname {p['circ']}\n" + OPTS)
    log(f"synthetic inputs {GRID}: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    run_cli(gen_a.main, ["-D", "1", "-o", p["opts"], p["matrix"]])
    log(f"gen_a: {time.perf_counter() - t0:.1f}s")
    return p


def read_field(path: str, var: str) -> np.ndarray:
    """A tracer variable via scipy's netCDF-3 reader (independent of the
    repo's codec)."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return np.array(f.variables[var].data, dtype=np.float64)


def check_solution(p: dict, out_path: str) -> dict:
    """Per-variable ||Ax-b||/||b|| in host float64 from the file written
    in place, b from the pre-solve copy; land cells must be untouched."""
    from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
        read_matrix_file)
    maps = load_ind_maps(p["matrix"])
    A = read_matrix_file(p["matrix"]).to_scipy()
    land = maps.int3_to_ind < 0
    res = {}
    for var in TRACERS:
        before = read_field(p["before"], var)
        after = read_field(out_path, var)
        b = maps.flatten_field(before)
        x = maps.flatten_field(after)
        res[var] = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
        check(np.array_equal(before[land], after[land]),
              f"{var}: land cells changed")
        check(not np.array_equal(b, x), f"{var}: not updated")
    log("residuals " + ", ".join(f"{v} {r:.3e}" for v, r in res.items())
        + f" (contract {CONTRACT:.0e}); land cells bit-identical")
    check(max(res.values()) <= CONTRACT,
          f"residual {max(res.values()):.3e} > {CONTRACT:.0e}")
    return res


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))


def phase_main(p: dict) -> None:
    import jax

    from nk_ocn_tracer_jacobian_precond_tpu.drivers import solve
    run_cli(solve.main, ["--memplan", p["matrix"]])
    t0 = time.perf_counter()
    out = run_cli(solve.main, ["-D", "1", "-v", ",".join(TRACERS),
                               p["matrix"], p["tracer"]])
    log(f"solve (cold: compile + factor + 4-rhs solve): "
        f"{time.perf_counter() - t0:.1f}s")
    check("factor precision: float64" in out, "factors are not float64")
    check_solution(p, p["tracer"])
    log(f"peak device memory {peak_bytes(jax.devices()[0]) / 2**30:.2f} "
        f"GiB")


def phase_newton(p: dict) -> None:
    import jax
    import jax.numpy as jnp

    from nk_ocn_tracer_jacobian_precond_tpu.grid import gen_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu.grid.grid import load_grid
    from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
        SparseMatrix, read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu.ops import (
        AssemblyOptions, PerTracerOptions)
    from nk_ocn_tracer_jacobian_precond_tpu.ops.assemble import (
        assemble_jacobian)
    from nk_ocn_tracer_jacobian_precond_tpu.ops.device_update import (
        build_update_plan)
    from nk_ocn_tracer_jacobian_precond_tpu.ops.fieldsource import (
        FileFieldSource)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import (
        MultifrontalFactorization)

    matrix = read_matrix_file(p["matrix"])
    maps = load_ind_maps(p["matrix"])
    B = np.stack([maps.flatten_field(read_field(p["before"], v))
                  for v in TRACERS], axis=1)
    t0 = time.perf_counter()
    fac = MultifrontalFactorization(matrix, maps=maps, refine_tol=CONTRACT)
    fac.solve(B)
    check(fac.engine.prec == jnp.float64, "facade factors are not float64")
    log(f"facade factor + solve (warm compile): "
        f"{time.perf_counter() - t0:.1f}s")
    grid = load_grid(p["circ"], None)
    opts = AssemblyOptions(
        circ_fname=p["circ"], adv_type="centered", hmix_type="isop_file",
        vmix_type="file",
        per_tracer=[PerTracerOptions(sink_type="const", sink_rate=1.21e-4)])
    asm = assemble_jacobian(grid, opts, FileFieldSource(p["circ"]), None,
                            gen_ind_maps(np.asarray(grid.KMT), grid.km))
    plan = build_update_plan(asm, matrix)
    upd = jax.jit(lambda s, c: plan.update(s * c))
    c = 1.0 + 1e-3 * np.random.default_rng(SEED).standard_normal(plan.total)
    t0 = time.perf_counter()
    nz = np.asarray(upd(jnp.asarray(plan.stack_fields(asm)), jnp.asarray(c)))
    t_upd = time.perf_counter() - t0
    check(nz.shape == matrix.nzval.shape and np.isfinite(nz).all(),
          "device update produced a bad value array")
    m_new = SparseMatrix(nzval=nz, colind=matrix.colind, rowptr=matrix.rowptr,
                         coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    refiner = fac._refiner
    t0 = time.perf_counter()
    fac.refactor(m_new)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = fac.solve(B)
    t_sol = time.perf_counter() - t0
    check(fac._refiner is refiner, "refactor rebuilt the refiner")
    A = m_new.to_scipy()
    rel = np.linalg.norm(A @ X - B, axis=0) / np.linalg.norm(B, axis=0)
    log(f"newton step: device update {t_upd:.2f}s, refactor {t_ref:.2f}s, "
        f"4-rhs solve {t_sol:.2f}s, residuals "
        + ", ".join(f"{r:.3e}" for r in rel))
    check(rel.max() <= CONTRACT, f"newton residual {rel.max():.3e}")


def phase_four(p: dict) -> None:
    import jax

    from nk_ocn_tracer_jacobian_precond_tpu.drivers import solve
    four = p["tracer"] + ".n4.nc"
    shutil.copy(p["tracer"], four)
    run_cli(solve.main, ["--memplan", "-n", "4,1", p["matrix"]])
    t0 = time.perf_counter()
    # -n nprow[,npcol] as in the reference: a lone "4" means a 4x4 grid
    out = run_cli(solve.main, ["-D", "1", "-n", "4,1", "-v",
                               ",".join(TRACERS), p["matrix"], four])
    log(f"solve -n 4,1 (cold): {time.perf_counter() - t0:.1f}s")
    check("factor precision: float64" in out, "factors are not float64")
    line = [s for s in out.splitlines() if "factor rounds sharded" in s]
    check(bool(line), "no sharded-round report")
    log(line[-1].split(") ", 1)[-1])
    peaks = [peak_bytes(d) for d in jax.devices()[:4]]
    log("peak device memory " + ", ".join(
        f"dev{i} {b / 2**30:.2f} GiB" for i, b in enumerate(peaks)))
    check(all(b > 0 for b in peaks), "a device holds no factor memory")
    check_solution(p, four)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card distributed solve")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        import jax

        from nk_ocn_tracer_jacobian_precond_tpu.utils.backend import (
            setup_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: cannot import the solver next to this script "
              f"({e})", file=sys.stderr)
        return 2
    n_cards = 4 if args.four else 1
    t_all = time.perf_counter()
    work = None
    try:
        devs = phase_device(n_cards)
        jax.config.update("jax_enable_x64", True)
        log(f"compile cache {setup_compile_cache()}")
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        p: dict = {}
        phases = ([("problem", lambda: p.update(make_problem(work))),
                   ("four", lambda: phase_four(p))] if args.four else
                  [("kernels", phase_kernels),
                   ("problem", lambda: p.update(make_problem(work))),
                   ("main", lambda: phase_main(p)),
                   ("newton", lambda: phase_newton(p))])
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            log(f"phase {name} ok ({time.perf_counter() - t0:.1f}s)")
    except Exception as e:  # noqa: BLE001 - any failure fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    finally:
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)
    log(f"total {time.perf_counter() - t_all:.1f}s")
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
