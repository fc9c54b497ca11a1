"""Multifrontal factorization facade: symbolic once, numeric per matrix,
solve per RHS batch, iterative refinement to direct-solver accuracy.

This is the from-scratch replacement for the SuperLU_DIST factor/solve
path (reference src/solve_ABglobal.c:349-409). The symbolic plan depends
only on the sparsity pattern and is reusable across Newton iterations —
an improvement over the reference, which recomputed symbolic analysis on
every run (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import numpy as np

from ..io.matrixfile import SparseMatrix
from ..utils import dbg, timed
from .symbolic import SymbolicFactorization, symbolic_from_matrix


def equilibrate(matrix: SparseMatrix, ruiz_iters: int = 8):
    """Iterated (Ruiz) row/column equilibration, powers of two.

    The rebuild of SuperLU's dgsequ/dlaqgs scaling step (which the
    reference's pdgssvx drivers run by default), strengthened: instead of
    one row-max pass then one column-max pass, scale both sides by
    1/sqrt(max|.|) repeatedly until every row and column max is within
    [1/2, 2]. Simultaneous convergence on both sides measurably reduces
    no-pivot element growth in the float32 factorization at depth
    (60-level problems), which is what bounds the refinement cycle count.
    Scaling by exact powers of two keeps the scaled entries
    bit-representable. Returns (scaled_matrix, dr, dc) with
    (Dr A Dc) y = Dr b, x = Dc y."""
    from scipy.sparse import csr_matrix

    A = matrix.to_scipy().tocsr()
    n = A.shape[0]
    rowcnt = np.diff(A.indptr)
    rows = np.repeat(np.arange(n), rowcnt)
    cols = A.indices
    a = np.abs(A.data)
    la0 = np.log2(np.where(a > 0, a, 1.0))
    ldr = np.zeros(n)
    ldc = np.zeros(n)
    # segment maxima via sort + reduceat: rows are CSR-sorted already;
    # columns get one reusable argsort. np.maximum.at was ~10x slower
    # (ufunc.at is scalar-dispatched) and equilibration sat at 18s of the
    # gx3 cold factor — this form is a few hundred ms
    row_ptr = A.indptr[:-1].astype(np.int64)
    row_has = rowcnt > 0
    col_order = np.argsort(cols, kind="stable")
    cols_sorted = cols[col_order]
    col_cnt = np.bincount(cols_sorted, minlength=n)
    col_ptr = (np.cumsum(col_cnt) - col_cnt).astype(np.int64)
    col_has = col_cnt > 0

    def _seg_max(vals, order, ptr, has):
        v = vals[order] if order is not None else vals
        out = np.zeros(n)
        # reduceat needs strictly valid segment starts: clamp empty
        # segments' starts and zero them after
        safe = np.minimum(ptr, max(len(v) - 1, 0))
        if len(v):
            out = np.maximum.reduceat(v, safe)
        out[~has] = 0.0
        return out

    for _ in range(ruiz_iters):
        la = la0 - ldr[rows] - ldc[cols]
        rmax = _seg_max(la, None, row_ptr, row_has)
        cmax = _seg_max(la, col_order, col_ptr, col_has)
        if max(np.abs(rmax).max(initial=0.0),
               np.abs(cmax).max(initial=0.0)) <= 1.0:
            break
        # simultaneous sqrt steps (Ruiz): both sides move by half their
        # log-deviation each sweep, which contracts geometrically where
        # full alternating steps oscillate on rows/columns that share
        # extreme entries
        ldr += rmax / 2
        ldc += cmax / 2
    dr = np.exp2(-np.round(ldr))
    dc = np.exp2(-np.round(ldc))
    data = A.data * dr[rows] * dc[cols]
    As = csr_matrix((data, A.indices, A.indptr), shape=A.shape)
    scaled = SparseMatrix(nzval=As.data, colind=As.indices.astype(np.int64),
                          rowptr=As.indptr.astype(np.int64),
                          coupled_tracer_cnt=matrix.coupled_tracer_cnt)
    return scaled, dr, dc


class MultifrontalFactorization:
    """impl: "jax" (the device engine; "auto" means the same) or "numpy"
    (the host reference engine, explicit only)."""

    def __init__(self, matrix: SparseMatrix, impl: str = "auto",
                 leaf_size: int = 32, refine_tol: float = 1e-13,
                 maps=None, sym: SymbolicFactorization | None = None,
                 n_devices: int | None = None, equilibrate_matrix: bool = True,
                 mesh=None, precision=None,
                 factor_checkpoint_dir: str | None = None,
                 rhs_devices: int = 1,
                 numeric_checkpoint: str | None = None):
        self.matrix = matrix
        self.A = matrix.to_scipy()
        self.refine_tol = refine_tol
        precision = _resolve_precision(precision)
        if mesh is None and n_devices is not None and n_devices > 1:
            # the distributed mode (reference solve_ABdist / -n nprow,npcol,
            # solve_ABglobal.c:61-77): shard the front batches over a device
            # mesh. make_mesh raises if the requested devices don't exist —
            # a silently-ignored parallelism flag is worse than an
            # unsupported one.
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(n_devices, ("front",), rhs_devices=rhs_devices)
        self.mesh = mesh
        if impl == "auto" or mesh is not None:
            impl = "jax"
        if sym is None:
            if maps is None:
                maps = _maps_from_matrix(matrix)
            with timed("symbolic analysis"):
                sym = symbolic_from_matrix(maps, matrix, leaf_size=leaf_size)
        self.sym = sym
        self.impl = impl
        if equilibrate_matrix:
            with timed("equilibration"):
                fac_matrix, self.dr, self.dc = equilibrate(matrix)
        else:
            fac_matrix, self.dr, self.dc = matrix, None, None
        self._fac_matrix = fac_matrix
        with timed(f"numeric factorization ({impl})"):
            if impl == "numpy":
                if numeric_checkpoint is not None:
                    import warnings
                    warnings.warn(
                        "numeric_checkpoint (--factors) is only supported "
                        "by the JAX engine; the numpy engine will factor "
                        "from scratch and NOT save/load the file",
                        RuntimeWarning, stacklevel=2)
                from .mf_numpy import NumpyMultifrontal
                self.engine = NumpyMultifrontal(sym, fac_matrix)
            elif impl == "jax":
                import os
                from .mf_jax import JaxMultifrontal
                # persisted numeric factors (the cross-RUN analog of the
                # reference's within-run options.Fact = FACTORED reuse,
                # solve_ABdist.c:539): a loadable checkpoint skips the
                # numeric phase outright; the file's matrix-value hash
                # guards against stale Newton-iteration factors
                loadable = (numeric_checkpoint is not None
                            and os.path.exists(numeric_checkpoint))
                self.engine = JaxMultifrontal(
                    sym, fac_matrix, mesh=self.mesh, precision=precision,
                    checkpoint_dir=factor_checkpoint_dir,
                    factorize=not loadable)
                loaded = False
                if loadable:
                    from .checkpoint import load_factors
                    try:
                        load_factors(numeric_checkpoint, self)
                        loaded = True
                        dbg(1, f"numeric factors loaded from "
                               f"{numeric_checkpoint}")
                    except Exception as e:  # stale/mismatched: refactor
                        dbg(1, f"factor checkpoint rejected "
                               f"({type(e).__name__}: {e}); refactoring")
                        self.engine._factorize(fac_matrix)
                if numeric_checkpoint is not None and not loaded:
                    from .checkpoint import save_factors
                    save_factors(numeric_checkpoint, self)
                    dbg(1, f"numeric factors saved to {numeric_checkpoint}")
            else:
                raise ValueError(f"unknown multifrontal impl: {impl}")
        dbg(1, f"factor precision: "
               f"{np.dtype(getattr(self.engine, 'prec', np.float64)).name}")

    def refactor(self, matrix: SparseMatrix | None = None) -> None:
        """Numeric refactorization with the same sparsity pattern — the
        Newton-iteration reuse path (new Jacobian values each outer
        iteration, identical symbolic plan and compiled kernels). The old
        factors are replaced in place; peak memory is one factor set plus
        the bounded per-chunk transients."""
        if matrix is not None:
            self.matrix = matrix
            self.A = matrix.to_scipy()
            if self.dr is not None:
                self._fac_matrix, self.dr, self.dc = equilibrate(matrix)
            else:
                self._fac_matrix = matrix
            # same sparsity pattern => rebind the refiner's device
            # operands in place; dropping it re-traced the fused
            # refinement program every Newton iteration (refine.rebind)
            ref = getattr(self, "_refiner", None)
            if ref is not None:
                ref.rebind(self.matrix, dr=self.dr, dc=self.dc,
                           precond_host=_scaled_solve(self.engine, self.dr,
                                                      self.dc))
        with timed("numeric refactorization"):
            self.engine._factorize(self._fac_matrix)

    def validate(self) -> dict:
        """Failure detection: scan the computed factors for non-finite
        entries (zero pivots / overflow in the low-precision factorization
        surface here first). The reference had no failure detection at all
        (SURVEY.md §5); SuperLU just ABORTs on allocation failure."""
        import numpy as np
        bad = 0
        total = 0
        factors = getattr(self.engine, "factors", None)
        if factors is not None:
            items = factors.values() if isinstance(factors, dict) else factors
            for item in items:
                if isinstance(item, tuple):
                    arrs = item
                elif hasattr(item, "__dataclass_fields__"):  # FrontFactors
                    arrs = (item.lu11, item.L21, item.U12)
                else:
                    arrs = (item,)
                for F in arrs:
                    arr = np.asarray(F)
                    if not np.issubdtype(arr.dtype, np.floating):
                        continue
                    bad += int((~np.isfinite(arr)).sum())
                    total += arr.size
        report = {"nonfinite_factor_entries": bad, "factor_entries": total}
        if bad:
            raise FloatingPointError(
                f"factorization produced {bad} non-finite entries "
                f"(singular pivot block or overflow): {report}")
        return report

    def _maybe_escalate_precision(self, rel: float) -> bool:
        """Factor-precision escalation: when the float32 factorization is
        too inaccurate for ANY refinement tier to repair (raw
        preconditioner error O(1) — measured on 60-level trees, where
        year-long implicit vertical diffusion drives elimination growth
        to ~1e5-1e11 and eps32 x growth >= 1), refactor in float64 and
        retry. This matches the reference's precision (SuperLU_DIST is
        float64 throughout, solve_ABdist.c:518); float32 stays the fast
        path for the shallow-tree problems where it demonstrably reaches
        the 1e-10 contract. Returns True if the engine was rebuilt.
        NK_ESCALATE=0 disables (tests that assert stall warnings)."""
        import os
        if self.impl != "jax" or os.environ.get("NK_ESCALATE", "1") == "0":
            return False
        import jax
        import jax.numpy as jnp
        if not jax.config.jax_enable_x64:
            return False
        if getattr(self.engine, "prec", None) != jnp.float32:
            return False
        # a float64 factor set that cannot fit the device is an OOM, not
        # a repair: refuse up front with actionable advice (a problem
        # whose float64 plan exceeds one device needs the multi-device
        # mesh, like the reference's 144-rank SuperLU_DIST runs)
        try:
            from .memplan import plan_memory
            ndev = (self.mesh.shape[self.engine.mesh_axis]
                    if self.mesh is not None else 1)
            peak = plan_memory(self.engine.plans, ndev, 8).peak_per_device
            lim = _device_memory_limit()
            if lim and peak > 0.92 * lim:
                import warnings
                warnings.warn(
                    f"float32 factors failed (max rel residual {rel:.3e}) "
                    f"but float64 factors need ~{peak / 1e9:.1f} GB/device "
                    f"vs ~{lim / 1e9:.1f} GB available — rerun with more "
                    f"devices (-n) or NK_PREC=f64 on a larger mesh",
                    RuntimeWarning, stacklevel=3)
                return False
        except Exception:
            pass    # no memory info: attempt the refactor anyway
        from .mf_jax import JaxMultifrontal
        dbg(1, f"solve escalation: float32 factors left max relative "
               f"residual {rel:.3e} (> {100 * self.refine_tol:.1e}); "
               f"refactoring in float64")
        # free the failed float32 factor set BEFORE the float64 build:
        # both sets resident at once is an avoidable OOM
        self.engine.factors = None
        self._refiner = None
        with timed("float64 escalation refactorization"):
            self.engine = JaxMultifrontal(
                self.sym, self._fac_matrix, mesh=self.mesh,
                precision=jnp.float64,
                checkpoint_dir=getattr(self.engine, "_ckpt_dir", None))
        self._refiner = None    # rebind to the new factors
        return True

    def _precond_solve(self, b: np.ndarray) -> np.ndarray:
        """Apply the (scaled) factorization: x ~= A^{-1} b."""
        return _scaled_solve(self.engine, self.dr, self.dc)(b)

    def _device_refiner(self):
        if getattr(self, "_refiner", None) is None:
            from .refine import DeviceRefiner
            self._refiner = DeviceRefiner(
                self.engine, self.matrix, dr=self.dr, dc=self.dc,
                tol=max(self.refine_tol, 1e-13),
                precond_host=_scaled_solve(self.engine, self.dr, self.dc))
        return self._refiner

    def solve(self, b: np.ndarray, refine: bool = True) -> np.ndarray:
        from .api import iterative_refinement
        b = np.asarray(b, dtype=np.float64)
        single = b.ndim == 1
        B = b[:, None] if single else b
        if refine and self.impl == "jax":
            import jax
            if jax.config.jax_enable_x64:
                # fully device-resident path: float64 SpMV + float32
                # preconditioner, batched over all RHS, one dispatch per
                # restart cycle (no host SpMVs, no per-iteration
                # host<->device round trips)
                X = self._device_refiner().solve(B)
                rel = _rel_residuals(self.A, X, B)
                if (rel.max() > 100 * self.refine_tol
                        and self._maybe_escalate_precision(rel.max())):
                    X = self._device_refiner().solve(B)
                    rel = _rel_residuals(self.A, X, B)
                if rel.max() > 100 * self.refine_tol:
                    import warnings
                    warnings.warn(
                        f"device GMRES-IR stalled at max relative residual "
                        f"{rel.max():.3e}", RuntimeWarning, stacklevel=2)
                return X[:, 0] if single else X
        with timed("mf solve"):
            X = self._precond_solve(B)
        if refine:
            with timed("mf refine"):
                X = iterative_refinement(self.A, self._precond_solve, B, X,
                                         tol=self.refine_tol)
            rel = _rel_residuals(self.A, X, B)
            if rel.max() > 100 * self.refine_tol:
                # plain refinement stalled or diverged (element growth x
                # low-precision factors); fall back to Krylov-accelerated
                # refinement with the factorization as preconditioner
                with timed("mf gmres-ir"):
                    X = self._gmres_ir(B, X)
                    # gmres converges the *preconditioned* residual; polish
                    # the true residual with plain refinement steps
                    X = iterative_refinement(self.A, self._precond_solve,
                                             B, X, tol=self.refine_tol)
                rel = _rel_residuals(self.A, X, B)
                if (rel.max() > 100 * self.refine_tol
                        and self._maybe_escalate_precision(rel.max())):
                    X = self._precond_solve(B)
                    X = iterative_refinement(self.A, self._precond_solve,
                                             B, X, tol=self.refine_tol)
                    rel = _rel_residuals(self.A, X, B)
                if rel.max() > 100 * self.refine_tol:
                    # never return a silently inaccurate solution: the
                    # backstop itself failed to converge
                    import warnings
                    warnings.warn(
                        f"solve did not reach target accuracy: max relative "
                        f"residual {rel.max():.3e} > "
                        f"{100 * self.refine_tol:.1e} after GMRES-IR "
                        f"(ill-conditioned matrix or factorization "
                        f"breakdown)", RuntimeWarning, stacklevel=2)
        return X[:, 0] if single else X

    def _gmres_ir(self, B: np.ndarray, X0: np.ndarray) -> np.ndarray:
        from scipy.sparse.linalg import LinearOperator, gmres
        n = self.A.shape[0]
        M = LinearOperator((n, n), matvec=lambda v: self._precond_solve(v))
        X = np.empty_like(X0)
        for j in range(B.shape[1]):
            x, info = gmres(self.A, B[:, j], x0=X0[:, j], M=M,
                            rtol=self.refine_tol, restart=30, maxiter=20)
            X[:, j] = x
            if info != 0:
                import warnings
                warnings.warn(f"gmres-ir did not converge for rhs {j} "
                              f"(info={info})", RuntimeWarning, stacklevel=2)
            dbg(1, f"gmres-ir rhs {j}: info={info}")
        return X


def _scaled_solve(engine, dr, dc):
    """x ~= A^{-1} b through the (scaled) factorization, as a callable
    that holds the engine and the scalings but not the facade. The facade
    owns the refiner that keeps this callable; a bound method here would
    close a reference cycle that keeps every factor on the device until
    the cyclic garbage collector runs."""
    def apply(b: np.ndarray) -> np.ndarray:
        if dr is None:
            return np.asarray(engine.solve(b), dtype=np.float64)
        scaled_b = dr[:, None] * b if b.ndim == 2 else dr * b
        y = np.asarray(engine.solve(scaled_b), dtype=np.float64)
        return dc[:, None] * y if y.ndim == 2 else dc * y
    return apply


def _device_memory_limit() -> int | None:
    """Per-device accelerator memory in bytes, when the backend exposes
    it (device memory_stats); None on hosts (CPU 'devices' share RAM and a
    plan-vs-RAM comparison there is the memplan's job, not this guard)."""
    import jax

    from ..utils.backend import platform
    if platform() == "cpu":
        return None
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("bytes_limit") or None


def _resolve_precision(precision):
    """Facade-level precision spec: a dtype, one of the strings
    'f32'/'float32'/'f64'/'float64'/'auto', or None. 'auto'/None defer to
    the engine's default (float64 whenever x64 is enabled, on every
    backend); float32 factors get the runtime escalation path
    (_maybe_escalate_precision). The NK_PREC env var overrides an unset
    precision."""
    import os
    if precision is None:
        precision = os.environ.get("NK_PREC") or None
    if precision is None or not isinstance(precision, str):
        return precision
    key = precision.lower()
    if key in ("auto", ""):
        return None
    try:
        import jax.numpy as jnp
        table = {"f32": jnp.float32, "float32": jnp.float32,
                 "f64": jnp.float64, "float64": jnp.float64}
    except Exception:
        table = {"f32": np.float32, "float32": np.float32,
                 "f64": np.float64, "float64": np.float64}
    if key not in table:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected f32, f64, or auto)")
    return table[key]


def _rel_residuals(A, X, B) -> np.ndarray:
    r = B - A @ X
    bn = np.linalg.norm(B, axis=0)
    bn[bn == 0] = 1.0
    return np.linalg.norm(r, axis=0) / bn


def _maps_from_matrix(matrix: SparseMatrix):
    raise ValueError(
        "MultifrontalFactorization needs index maps (pass maps=...) when "
        "constructed from a bare SparseMatrix")

