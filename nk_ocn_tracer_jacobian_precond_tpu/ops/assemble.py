"""Jacobian assembly pipeline and canonical CSR emission.

Rebuild of gen_sparse_matrix (src/matrix.c:3774-3840). The Jacobian lives
as a *structured stencil tensor* — per-offset dense coefficient fields plus
optional within-column dense blocks and cross-tracer diagonals — which is
(a) the natural vectorized assembly target, (b) directly usable as a
matrix-free SpMV operator on the device, and (c) deterministically compacted into
the reference's canonical CSR (duplicates summed in slot order, exact zeros
stripped, columns sorted; src/matrix.c:3826-3832).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..grid import Grid, IndexMaps, gen_ind_maps
from ..utils import dbg, timed
from . import adv as adv_ops
from . import hmix as hmix_ops
from . import sink as sink_ops
from . import vmix as vmix_ops
from .offsets import ADV2_OFFSETS, FACE_OFFSETS, ISOP_OFFSETS, target_wet, wet3d
from .options import AssemblyOptions


class CoefDict(dict):
    """offset -> (km, jmt, imt) float64, auto-zeros on first access."""

    def __init__(self, shape):
        super().__init__()
        self._shape = shape

    def __missing__(self, key):
        arr = np.zeros(self._shape)
        self[key] = arr
        return arr


@dataclass
class Assembly:
    """The assembled Jacobian in structured form.

    shared: offset -> field; identical for every tracer diagonal block
        (advection + mixing are tracer-independent in the reference: each
        add_* pass loops tracers adding the same values, matrix.c:1224).
    self_full: per-tracer (0,0,0) coefficient — a copy of the shared self
        continued with the per-tracer passes (sinks, piston velocity,
        surface-flux derivative) in reference order, preserving the
        left-to-right addition order within the self slot.
    vmix_dense: (km2, km, jmt, imt) within-column dense block (matrix_file
        vertical mixing), shared across tracers; None if absent.
    sink_dense: per-tracer (km2, km, jmt, imt) source-level blocks.
    cross: (t, t2) -> field; cross-tracer same-cell coupling.
    """

    grid: Grid
    opts: AssemblyOptions
    maps: IndexMaps
    shared: CoefDict
    self_full: list[np.ndarray]
    vmix_dense: np.ndarray | None
    sink_dense: list[np.ndarray | None]
    cross: dict = field(default_factory=dict)

    @property
    def nt(self) -> int:
        return self.opts.coupled_tracer_cnt

    @property
    def flat_len(self) -> int:
        return self.nt * self.maps.tracer_state_len

    def self_coef(self, t: int) -> np.ndarray:
        return self.self_full[t]


def assemble_jacobian(grid: Grid, opts: AssemblyOptions, circ_src,
                      tracer_src=None, maps: IndexMaps | None = None) -> Assembly:
    """Run the fixed assembly pipeline (order matters — adv must precede
    adv_enforce_divfree which overwrites the self coefficient,
    src/matrix.c:3795-3800)."""
    opts.validate()
    if maps is None:
        maps = gen_ind_maps(np.asarray(grid.KMT), grid.km)
    shape = (grid.km, grid.jmt, grid.imt)
    shared = CoefDict(shape)
    nt = opts.coupled_tracer_cnt

    with timed("add_adv"):
        adv_ops.add_adv(shared, grid, opts, circ_src)
    if opts.l_adv_enforce_divfree:
        with timed("adv_enforce_divfree"):
            adv_ops.adv_enforce_divfree(shared, opts.adv_type)
    with timed("add_hmix"):
        hmix_ops.add_hmix(shared, grid, opts, circ_src)
    with timed("add_vmix"):
        vmix_dense = vmix_ops.add_vmix(shared, grid, opts, circ_src)

    # per-tracer passes continue accumulating onto a copy of the shared
    # self coefficient, in reference op order (the shared part is fully
    # accumulated before any per-tracer pass runs, so the left-to-right
    # addition order within the self slot matches the reference pipeline)
    self_full = [shared[(0, 0, 0)].copy() for _ in range(nt)]
    sink_dense: list[np.ndarray | None] = [None] * nt
    cross = CoefDict(shape)
    for t in range(nt):
        sink_ops.add_sink_pure_diag(self_full[t], grid, opts, t, tracer_src)
        sink_ops.add_sink_generic_tracer_diag(self_full[t], grid, opts, t, tracer_src)
        sink_dense[t] = sink_ops.add_sink_generic_tracer_dense(grid, opts, t, tracer_src)
    sink_ops.add_sink_coupled_tracers(cross, opts, tracer_src)
    for t in range(nt):
        sink_ops.add_pv(self_full[t], grid, opts, t, tracer_src)
    for t in range(nt):
        sink_ops.add_d_SF_d_TRACER(self_full[t], grid, opts, t, tracer_src)
    sink_ops.add_sf_coupled_tracers(cross, grid, opts, tracer_src)

    return Assembly(grid=grid, opts=opts, maps=maps, shared=shared,
                    self_full=self_full, vmix_dense=vmix_dense,
                    sink_dense=sink_dense, cross=dict(cross))


# ---------------------------------------------------------------------------
# canonical CSR emission
# ---------------------------------------------------------------------------


def _offset_order(opts: AssemblyOptions):
    """Within-row slot order of init_matrix (src/matrix.c:800-961)."""
    order = list(FACE_OFFSETS)
    if opts.adv_type == "upwind3":
        order += ADV2_OFFSETS
    if opts.hmix_type == "isop_file":
        order += ISOP_OFFSETS
    return order


def to_csr(asm: Assembly):
    """Compact the structured form to the reference's canonical CSR.

    Returns (nzval, colind, rowptr) with rows in flat order
    (tracer-major, then the j/i/k wet-cell enumeration), duplicates summed
    in slot order (sum_dup_vals, matrix.c:3620-3650), exact zeros stripped
    (strip_matrix_zeros, matrix.c:3656-3688), and columns sorted
    (sort_cols_all_rows, matrix.c:3752-3770).
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

    rows_chunks, cols_chunks, vals_chunks = [], [], []

    def emit(rows, cols, vals):
        rows_chunks.append(rows.astype(np.int64))
        cols_chunks.append(cols.astype(np.int64))
        vals_chunks.append(np.asarray(vals, dtype=np.float64))

    offsets = _offset_order(opts)
    # cache per-offset validity and target column index
    off_cache = {}
    for off in offsets:
        dk, dj, di = off
        valid = wet & target_wet(KMT, km, dk, dj, di)
        tk = np.clip(kk + dk, 0, km - 1)
        tj = np.clip(jj + dj, 0, jmt - 1)
        ti = (ii + di) % imt
        tgt = int3[tk, tj, ti]
        off_cache[off] = (valid, tgt)

    row_of_cell = int3  # (km,jmt,imt), -1 on land

    for t in range(nt):
        base = t * tsl
        # stencil offsets, in slot order
        for off in offsets:
            valid, tgt = off_cache[off]
            coef = asm.self_coef(t) if off == (0, 0, 0) else asm.shared[off]
            v = coef[valid]
            emit(base + row_of_cell[valid], base + tgt[valid], v)
        # vmix within-column dense block, k2 ascending (matrix.c:931-940)
        if asm.vmix_dense is not None:
            for k2 in range(km):
                valid = wet & (k2 < KMT[None])
                emit(base + row_of_cell[valid],
                     base + int3[k2][None].repeat(km, 0)[valid],
                     asm.vmix_dense[k2][valid])
        # sink source-level dense block, k2 DESCENDING (matrix.c:941-953)
        if asm.sink_dense[t] is not None:
            kmax = sink_ops.sink_dense_row_limit(opts.per_tracer[t], km)
            for k2 in range(km - 1, -1, -1):
                if k2 > kmax:
                    continue
                valid = wet & (kk >= k2)
                emit(base + row_of_cell[valid],
                     base + int3[k2][None].repeat(km, 0)[valid],
                     asm.sink_dense[t][k2][valid])
        # cross-tracer same-cell slots, t2 ascending (matrix.c:954-961)
        for t2 in range(nt):
            if t2 == t:
                continue
            coef = asm.cross.get((t, t2))
            if coef is None:
                coef = np.zeros((km, jmt, imt))
            emit(base + row_of_cell[wet], t2 * tsl + int3[wet], coef[wet])

    rows = np.concatenate(rows_chunks)
    cols = np.concatenate(cols_chunks)
    vals = np.concatenate(vals_chunks)
    flat_len = nt * tsl

    # canonicalize: sort by (row, col, emission order); reduce duplicates
    # left-to-right, reproducing sum_dup_vals' in-row first-occurrence
    # accumulation; strip exact zeros. Native C++ path when available.
    from ..native import canonicalize_coo
    native = canonicalize_coo(rows, cols, vals, flat_len)
    if native is not None:
        nzval, colind, rowptr = native
        dbg(1, f"nnz = {len(nzval)}")
        return nzval, colind, rowptr

    seq = np.concatenate([np.full(len(c), idx, dtype=np.int64)
                          for idx, c in enumerate(rows_chunks)])
    order = np.lexsort((seq, cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    new_group = np.empty(len(rows), dtype=bool)
    new_group[0] = True
    np.not_equal(rows[1:] * flat_len + cols[1:], rows[:-1] * flat_len + cols[:-1],
                 out=new_group[1:])
    starts = np.flatnonzero(new_group)
    summed = np.add.reduceat(vals, starts)
    g_rows = rows[starts]
    g_cols = cols[starts]

    nonzero = summed != 0.0
    nzval = summed[nonzero]
    colind = g_cols[nonzero]
    out_rows = g_rows[nonzero]
    rowptr = np.zeros(flat_len + 1, dtype=np.int64)
    np.add.at(rowptr, out_rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    dbg(1, f"nnz = {len(nzval)}")
    return nzval, colind, rowptr


def structural_nnz(asm: Assembly) -> int:
    """Pre-strip structural nonzero count, the rebuild of comp_nnz
    (src/matrix.c:595-661); useful for validation."""
    grid, opts, maps = asm.grid, asm.opts, asm.maps
    km = grid.km
    KMT = np.asarray(grid.KMT)
    wet = wet3d(KMT, km)
    kk = np.arange(km)[:, None, None]
    nnz = 0
    per_tracer_base = 0
    face = [o for o in FACE_OFFSETS]
    for off in face:
        per_tracer_base += int((wet & target_wet(KMT, km, *off)).sum())
    if opts.adv_type == "upwind3":
        for off in ADV2_OFFSETS:
            per_tracer_base += int((wet & target_wet(KMT, km, *off)).sum())
    if opts.hmix_type == "isop_file":
        for off in ISOP_OFFSETS:
            per_tracer_base += int((wet & target_wet(KMT, km, *off)).sum())
    if opts.vmix_type == "matrix_file":
        per_tracer_base += int((KMT.astype(np.int64) ** 2).sum())
    nt = opts.coupled_tracer_cnt
    for t in range(nt):
        nnz += per_tracer_base
        pt = opts.per_tracer[t]
        if pt.sink_type == "generic_tracer":
            kmax = sink_ops.sink_dense_row_limit(pt, km)
            cnt = np.minimum(kk, kmax) + 1
            nnz += int(np.where(wet, cnt, 0).sum())
        nnz += (nt - 1) * maps.tracer_state_len
    return nnz
