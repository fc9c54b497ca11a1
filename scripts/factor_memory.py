#!/usr/bin/env python
"""Device memory of the numeric factorization, program by program.

    python scripts/factor_memory.py [--imt 100 --jmt 116 --km 60]

Builds the synthetic problem (circulation seed 7, the chip_smoke option
set; gx3deep by default), compiles every factor-round program the engine
dispatches (_assemble, _extend_add per child group, _partial_factor) for
this device and prints XLA's compiled memory analysis for each: argument,
output and temporary bytes. It then walks the rounds the way
solver/memplan.py does, with each round's working set taken from the
compiled programs instead of the plan's front-stack estimate, runs one
factorization and prints the measured peak_bytes_in_use beside both
predictions, then memplan's peak for a four-device mesh. Full-size runs
belong on the GPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPTS = ("adv_type centered\nhmix_type isop_file\nvmix_type file\n"
        "sink_type const 1.21e-4\n")


def build(work: str, imt: int, jmt: int, km: int):
    from nk_ocn_tracer_jacobian_precond_tpu.drivers.gen_a import main as gen_a
    from nk_ocn_tracer_jacobian_precond_tpu.grid.indmap import load_ind_maps
    from nk_ocn_tracer_jacobian_precond_tpu.io.matrixfile import (
        read_matrix_file)
    from nk_ocn_tracer_jacobian_precond_tpu.testdata import make_circ_file
    circ = os.path.join(work, "circ.nc")
    opts = os.path.join(work, "opts.txt")
    mat = os.path.join(work, "matrix.nc")
    make_circ_file(circ, imt=imt, jmt=jmt, km=km, seed=7)
    with open(opts, "w") as f:
        f.write(f"circ_fname {circ}\n" + OPTS)
    if gen_a(["-o", opts, mat]) != 0:
        raise SystemExit("gen_a failed")
    return read_matrix_file(mat), load_ind_maps(mat)


def program_memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return dict(arg=m.argument_size_in_bytes, out=m.output_size_in_bytes,
                temp=m.temp_size_in_bytes, alias=m.alias_size_in_bytes)


def round_programs(eng, plan, cc, nnz: int, tau: float) -> dict:
    """Compile the round's programs with the engine's own arguments and
    return their memory analyses by name."""
    import jax

    from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
    prec = eng.prec
    nz = jax.ShapeDtypeStruct((nnz + 1,), prec)
    F = jax.ShapeDtypeStruct((plan.B, plan.N, plan.N), prec)
    out = {"assemble": program_memory(mf_jax._assemble.lower(
        nz, cc["a_col"], cc["a_csrc"], cc["a_pos"], cc["a_src"],
        cc["p_arr"], N=plan.N, P=plan.P, spill=cc["spill"]).compile())}
    for gi, g in enumerate(plan.child_groups):
        src = eng.plans[g.src_round]
        S = jax.ShapeDtypeStruct((src.B, src.M, src.M), prec)
        _, ss, ds, inv = cc["groups"][gi]
        out[f"extend_add[{g.src_round}]"] = program_memory(
            mf_jax._extend_add.lower(F, S, ss, ds, inv).compile())
    with jax.default_matmul_precision("highest"):
        out["partial_factor"] = program_memory(mf_jax._partial_factor.lower(
            F, P=plan.P, p_arr=cc["p_arr"], tau=tau,
            allow_native_lu=eng.mesh is None,
            pack_bs=eng._pack_bs).compile())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--imt", type=int, default=100)
    ap.add_argument("--jmt", type=int, default=116)
    ap.add_argument("--km", type=int, default=60)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_enable_x64", True)

    from nk_ocn_tracer_jacobian_precond_tpu.solver.memplan import (
        pf_temp_bytes, plan_memory)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf import equilibrate
    from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
        JaxMultifrontal, build_plan)
    from nk_ocn_tracer_jacobian_precond_tpu.solver.symbolic import (
        symbolic_from_matrix)
    from nk_ocn_tracer_jacobian_precond_tpu.utils.backend import (
        setup_compile_cache)
    setup_compile_cache()
    dev = jax.devices()[0]
    print(f"# device {dev.platform} {dev.device_kind}", flush=True)
    with tempfile.TemporaryDirectory(prefix="factor_memory_") as work:
        matrix, maps = build(work, args.imt, args.jmt, args.km)
    scaled, _, _ = equilibrate(matrix)
    sym = symbolic_from_matrix(maps, matrix)
    eng = JaxMultifrontal(sym, scaled, factorize=False)
    e = np.dtype(eng.prec).itemsize
    mp = plan_memory(eng.plans, 1, e)
    amax = float(np.max(np.abs(scaled.nzval)))
    tau = float(np.float32(np.sqrt(np.finfo(eng.prec).eps) * amax))
    gib = 2.0 ** -30
    print("# round B P N M | front GiB | largest program | partial_factor "
          "arg/out/temp GiB (temp/front, memplan's bound) | memplan "
          "highwater GiB | compiled walk GiB",
          flush=True)
    # the walk: factors of earlier rounds + Schur stacks still awaiting a
    # consumer + the largest program's arguments, outputs and temporaries
    last_use = {}
    for rnd, plan in enumerate(eng.plans):
        for g in plan.child_groups:
            last_use[g.src_round] = rnd
    live: dict[int, int] = {}
    fac = 0
    walk_peak = 0
    worst = (0, "", -1)
    t0 = time.perf_counter()
    for rnd, plan in enumerate(eng.plans):
        progs = round_programs(eng, plan, eng._consts[rnd], scaled.nnz, tau)
        front = plan.B * plan.N * plan.N * e
        own = {k: v["arg"] + v["out"] + v["temp"] - v["alias"]
               for k, v in progs.items()}
        name = max(own, key=own.get)
        for k, v in progs.items():
            if v["temp"] > worst[0]:
                worst = (v["temp"], k, rnd)
        # Schur stacks consumed by this round are arguments of its
        # extend-add programs (counted in own[]); the others stay live
        others = sum(b for r, b in live.items() if last_use.get(r) != rnd)
        walk = fac + others + own[name]
        walk_peak = max(walk_peak, walk)
        pf = progs["partial_factor"]
        bound = pf_temp_bytes(plan.B, plan.P, plan.N, e,
                              native_lu=plan.B <= 2) / front
        print(f"{rnd:3d} {plan.B:4d} {plan.P:5d} {plan.N:5d} {plan.M:5d} | "
              f"{front * gib:6.2f} | {name} | "
              f"{pf['arg'] * gib:.2f}/{pf['out'] * gib:.2f}/"
              f"{pf['temp'] * gib:.2f} ({pf['temp'] / front:.2f}x, "
              f"{bound:.2f}x) | "
              f"{mp.rounds[rnd]['highwater_dev'] * gib:6.2f} | "
              f"{walk * gib:6.2f}", flush=True)
        for r, lr in list(last_use.items()):
            if lr == rnd:
                live.pop(r, None)
        live[rnd] = plan.B * plan.M * plan.M * e
        fac += mp.rounds[rnd]["factor"]
    print(f"# compiled {len(eng.plans)} rounds in "
          f"{time.perf_counter() - t0:.1f}s; largest temporary buffer "
          f"{worst[0] * gib:.2f} GiB ({worst[1]}, round {worst[2]})")
    before = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    t0 = time.perf_counter()
    eng.refactor(scaled)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    print(f"# factor {time.perf_counter() - t0:.1f}s; peak_bytes_in_use "
          f"{before * gib:.2f} GiB before it (compilation), "
          f"{peak * gib:.2f} GiB after; memplan peak "
          f"{mp.peak_per_device * gib:.2f} GiB; compiled walk "
          f"{walk_peak * gib:.2f} GiB", flush=True)
    mp4 = plan_memory(build_plan(sym, scaled, batch_multiple=4), 4, e)
    print(f"# memplan on a four-device mesh: peak "
          f"{mp4.peak_per_device * gib:.2f} GiB/device")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
