"""Device-side Newton-iteration value updates on a frozen sparsity pattern.

The reference's Newton-Krylov workflow re-generates the Jacobian every
outer iteration with NEW VALUES on the SAME pattern (its hot loops are
the per-cell re-assembly passes, src/matrix.c:1224-1280 and 2233-2376,
followed by SuperLU_DIST's options.Fact = SamePattern path). Re-running
the host assembly + canonicalization per iteration costs seconds at gx3
and minutes at gx1 of pure host passes feeding an idle device.

This module freezes the VALUE PIPELINE instead: the structured stencil
form (ops/assemble.py) is a set of dense coefficient fields; the
canonical CSR is a fixed linear selection+reduction over those fields.
Both are precomputed ONCE into a `StencilUpdatePlan`:

  * the fields stack into one flat device vector (`stack_fields`),
  * every canonical nonzero is the left-fold sum of <= W stacked
    entries, ELL-packed as a (nnz, W) gather table (duplicate (row,col)
    emissions — e.g. the self slot plus a vmix dense diagonal hit — sum
    in the reference's emission order, so the fold order matches
    sum_dup_vals, src/matrix.c:3620-3650 bit-for-bit),

after which a Newton iteration's re-assembly is ONE jitted gather+fold
over the stacked fields — O(ms) on chip, no host pass over the matrix.

Pattern freezing matches the reference's own contract: SuperLU_DIST is
driven with SamePattern reuse, so a coefficient that was identically
zero at pattern time (struck by strip_matrix_zeros, matrix.c:3656-3688)
stays structurally absent even if a later iterate would make it
nonzero. `build_update_plan` validates itself by reproducing the
canonical (nzval, colind, rowptr) of the matrix it was built from.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import dbg, timed
from .assemble import Assembly, _offset_order
from .offsets import target_wet, wet3d
from . import sink as sink_ops


@dataclass
class StencilUpdatePlan:
    """Frozen mapping: stacked coefficient fields -> canonical nzval.

    layout: field key -> (base offset, shape) in the stacked vector.
        Keys: ("shared", off), ("self", t), ("vmix",), ("sinkd", t),
        ("cross", t, t2) — exactly the Assembly's distinct field arrays.
    ell_src: (nnz, W) indices into the stacked vector extended by one
        trailing zero sentinel; column w holds the w-th duplicate
        contribution in emission order (sentinel when the group is
        shorter).
    """

    layout: dict
    total: int
    ell_src: np.ndarray
    nnz: int

    def stack_fields(self, asm: Assembly) -> np.ndarray:
        """Flatten an Assembly's coefficient fields into the stacked
        vector this plan gathers from (host-side convenience; the NK
        loop can equally well produce the same vector on device)."""
        out = np.zeros(self.total, dtype=np.float64)
        for key, (base, shape) in self.layout.items():
            f = _field_of(asm, key)
            if f is None:
                continue
            assert f.shape == shape, (key, f.shape, shape)
            out[base:base + f.size] = f.ravel()
        return out

    def update(self, stacked):
        """nzval = fold(stacked[ell_src]) — jit-compatible (jnp in, jnp
        out); with numpy input computes on host identically."""
        import jax.numpy as jnp
        xp = jnp if not isinstance(stacked, np.ndarray) else np
        se = xp.concatenate([stacked, xp.zeros(1, stacked.dtype)])
        g = se[self.ell_src]
        acc = g[:, 0]
        # left fold in emission order: bit-identical to the canonical
        # CSR's duplicate summation (np.add.reduceat / nk_core.cpp)
        for w in range(1, self.ell_src.shape[1]):
            acc = acc + g[:, w]
        return acc


def _field_of(asm: Assembly, key):
    kind = key[0]
    if kind == "shared":
        return asm.shared.get(key[1])
    if kind == "self":
        return asm.self_full[key[1]]
    if kind == "vmix":
        return asm.vmix_dense
    if kind == "sinkd":
        return asm.sink_dense[key[1]]
    if kind == "cross":
        return asm.cross.get((key[1], key[2]))
    raise KeyError(key)


def build_update_plan(asm: Assembly, matrix=None) -> StencilUpdatePlan:
    """Build the frozen update plan from a first assembly (host, once
    per pattern — the analog of the symbolic phase for values).

    Replays to_csr's emission EXACTLY (same chunks, same order,
    src/matrix.c:800-961 slot order), but emits stacked-vector INDICES
    alongside values; canonicalizes; ELL-packs the kept groups. If
    ``matrix`` (the SparseMatrix built by to_csr from the same
    assembly) is given, the plan is validated against it: same pattern,
    and plan.update(stack) == matrix.nzval bit-for-bit.
    """
    grid, opts, maps = asm.grid, asm.opts, asm.maps
    km, jmt, imt = grid.km, grid.jmt, grid.imt
    KMT = np.asarray(grid.KMT)
    tsl = maps.tracer_state_len
    nt = asm.nt
    wet = wet3d(KMT, km)
    int3 = maps.int3_to_ind
    kk, jj, ii = np.meshgrid(np.arange(km), np.arange(jmt), np.arange(imt),
                             indexing="ij")

    # stacked layout: every distinct field array the emission touches
    layout: dict = {}
    total = 0

    def add_field(key, shape):
        nonlocal total
        if key not in layout:
            layout[key] = (total, shape)
            total += int(np.prod(shape))
        return layout[key][0]

    cell3 = (kk * (jmt * imt) + jj * imt + ii)   # flat (km,jmt,imt) index

    rows_chunks, cols_chunks, src_chunks, val_chunks = [], [], [], []

    def emit(rows, cols, src, vals):
        rows_chunks.append(rows.astype(np.int64))
        cols_chunks.append(cols.astype(np.int64))
        src_chunks.append(src.astype(np.int64))
        val_chunks.append(np.asarray(vals, dtype=np.float64))

    offsets = _offset_order(opts)
    off_cache = {}
    for off in offsets:
        dk, dj, di = off
        valid = wet & target_wet(KMT, km, dk, dj, di)
        tk = np.clip(kk + dk, 0, km - 1)
        tj = np.clip(jj + dj, 0, jmt - 1)
        ti = (ii + di) % imt
        off_cache[off] = (valid, int3[tk, tj, ti])

    for t in range(nt):
        base_r = t * tsl
        for off in offsets:
            valid, tgt = off_cache[off]
            if off == (0, 0, 0):
                fkey, coef = ("self", t), asm.self_coef(t)
            else:
                fkey, coef = ("shared", off), asm.shared[off]
            fb = add_field(fkey, coef.shape)
            emit(base_r + int3[valid], base_r + tgt[valid],
                 fb + cell3[valid], coef[valid])
        if asm.vmix_dense is not None:
            fb = add_field(("vmix",), asm.vmix_dense.shape)
            for k2 in range(km):
                valid = wet & (k2 < KMT[None])
                emit(base_r + int3[valid],
                     base_r + int3[k2][None].repeat(km, 0)[valid],
                     fb + k2 * (km * jmt * imt) + cell3[valid],
                     asm.vmix_dense[k2][valid])
        if asm.sink_dense[t] is not None:
            fb = add_field(("sinkd", t), asm.sink_dense[t].shape)
            kmax = sink_ops.sink_dense_row_limit(opts.per_tracer[t], km)
            for k2 in range(km - 1, -1, -1):
                if k2 > kmax:
                    continue
                valid = wet & (kk >= k2)
                emit(base_r + int3[valid],
                     base_r + int3[k2][None].repeat(km, 0)[valid],
                     fb + k2 * (km * jmt * imt) + cell3[valid],
                     asm.sink_dense[t][k2][valid])
        for t2 in range(nt):
            if t2 == t:
                continue
            coef = asm.cross.get((t, t2))
            if coef is None:
                # absent coupling: to_csr emits zeros that strip; the
                # frozen pattern has no slots for it, so neither do we
                continue
            fb = add_field(("cross", t, t2), coef.shape)
            emit(base_r + int3[wet], t2 * tsl + int3[wet],
                 fb + cell3[wet], coef[wet])

    rows = np.concatenate(rows_chunks)
    cols = np.concatenate(cols_chunks)
    src = np.concatenate(src_chunks)
    vals = np.concatenate(val_chunks)
    seq = np.concatenate([np.full(len(c), i, dtype=np.int64)
                          for i, c in enumerate(rows_chunks)])
    flat_len = nt * tsl

    order = np.lexsort((seq, cols, rows))
    rows, cols, src, vals = rows[order], cols[order], src[order], vals[order]
    key = rows * flat_len + cols
    new_group = np.empty(len(rows), dtype=bool)
    new_group[0] = True
    np.not_equal(key[1:], key[:-1], out=new_group[1:])
    starts = np.flatnonzero(new_group)
    counts = np.diff(np.append(starts, len(rows)))
    # exact left-fold group sums (order already emission order in-group)
    sums = np.add.reduceat(vals, starts)
    keep = sums != 0.0

    W = int(counts[keep].max()) if keep.any() else 1
    nnz = int(keep.sum())
    ell = np.full((nnz, W), total, dtype=np.int64)  # sentinel = zero slot
    kstarts = starts[keep]
    kcounts = counts[keep]
    for w in range(W):
        sel = kcounts > w
        ell[sel, w] = src[kstarts[sel] + w]
    if total + 1 < np.iinfo(np.int32).max:
        ell = ell.astype(np.int32)

    plan = StencilUpdatePlan(layout=layout, total=total, ell_src=ell,
                             nnz=nnz)

    if matrix is not None:
        # self-validation: frozen pattern must equal the canonical CSR
        g_rows, g_cols = rows[kstarts], cols[kstarts]
        rp = np.zeros(flat_len + 1, dtype=np.int64)
        np.add.at(rp, g_rows + 1, 1)
        rp = np.cumsum(rp)
        assert np.array_equal(rp, np.asarray(matrix.rowptr)), \
            "update plan rowptr mismatch vs canonical CSR"
        assert np.array_equal(g_cols, np.asarray(matrix.colind)), \
            "update plan colind mismatch vs canonical CSR"
        got = plan.update(plan.stack_fields(asm))
        assert np.array_equal(got, np.asarray(matrix.nzval)), \
            "update plan values mismatch vs canonical CSR"
        dbg(1, f"update plan validated: nnz={nnz} W={W} "
               f"stacked={total} ({len(layout)} fields)")
    return plan
