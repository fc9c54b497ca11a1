"""Newton-Krylov ocean-tracer Jacobian preconditioner framework in JAX.

A from-scratch rebuild of the capabilities of the reference toolchain
(klindsay28/NK_ocn_tracer_jacobian_precond): stage 1 assembles a sparse
approximation of the Jacobian of the one-year ocean tracer propagator from
POP circulation diagnostics (reference: src/gen_A.c, src/matrix.c); stage 2
LU-factors that matrix once and reuses the factorization to solve one linear
system per tracer variable (reference: src/solve_ABglobal.c,
src/solve_ABdist.c, built on SuperLU_DIST + MPI).

This package is accelerator-first (CPU and NVIDIA GPU):
  * assembly is vectorized array code over structured stencil fields
    (ops/), not per-cell loops;
  * the sparse direct solver (solver/) is a nested-dissection multifrontal
    factorization whose numeric phase is batched dense float64 GEMM/TRSM
    work on the device, with host-side symbolic analysis;
  * distribution uses jax.sharding meshes + collectives (parallel/), not MPI;
  * persistence (io/) is a from-scratch NetCDF-3 (classic / 64-bit offset)
    codec producing files bit-compatible with the reference's on-disk format.
"""

__version__ = "0.1.0"
