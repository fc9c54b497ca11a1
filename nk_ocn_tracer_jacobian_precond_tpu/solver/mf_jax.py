"""Multifrontal numeric phase — JAX implementation (CPU and NVIDIA GPU).

Executes the symbolic plan as *rounds* of batched dense linear algebra:
all fronts in a round are padded to one (B, N, N) tensor, assembled by a
single scatter of the CSR values, extended with their children's Schur
complements via padded gathers (no giant scatter index tensors), and
partially factored with a blocked LU with restricted partial pivoting
(pivot rows confined to fully-summed rows; XLA's native batched LU for
the small-batch tree-top rounds) whose panel updates are GEMMs, and
whose pivot-block triangles are inverted at factor time (blocked GEMM
inversion) so the per-RHS solve path is GEMM-only. This is the
accelerator replacement for SuperLU_DIST's pdgstrf supernodal factorization
(reference SuperLU_brief_tree.txt:12-14); like SuperLU_DIST's
static-pivoting GESP strategy, accuracy lost to restricted pivoting is
recovered by mixed-precision refinement (solver/refine.py).

With a device mesh, every round's batch axis is sharded (GSPMD): plan
constants carry NamedShardings and the sharding propagates through
assembly, extend-add, factor kernels, and the level-wave solves — the
device-mesh form of SuperLU_DIST's 2-D process-grid distribution.

Precision: factors are computed in PREC (float64 by default whenever x64
is enabled, on every backend — the reference's precision; float32 on
request), solves run in the same precision, refinement always accumulates
the residual in float64.

Shape discipline: every round's (B, P, N) is padded to bucketed sizes
(powers of two, multiples of LANE=128 for big fronts) so compiled kernels
are reused across rounds/matrices with the same padded shapes. The
eliminated block's padding carries an identity diagonal so the unpivoted
LU never divides by zero.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.lax.linalg import triangular_solve

from ..io.matrixfile import SparseMatrix
from ..utils import dbg, timed
from ..utils.backend import platform, setup_compile_cache
from .symbolic import SymbolicFactorization

LANE = 128
PANEL = 128

# Solve-side packed-inverse block size (single-device engines): the
# factorization's pivot blocks are repacked with inverted SOLVE_BS-wide
# diagonal blocks, so a triangular apply costs P/SOLVE_BS sequential
# GEMM steps per round instead of P/PANEL. Larger blocks cut the warm
# solve's dispatch-critical-path ~linearly; apply error grows with the
# bs-block conditioning and is absorbed by GMRES-IR. Default is ADAPTIVE
# (see JaxMultifrontal.__init__): element growth scales with tree depth, so shallow trees afford wider
# (faster) blocks than the 60-level production class. NK_SOLVE_BS
# overrides. Mesh engines pin 128 (the masked substitution's KD stack
# and checkpoint compatibility).
import os as _os
SOLVE_BS = int(_os.environ.get("NK_SOLVE_BS", "0"))


def _round_up(x: int, m: int) -> int:
    return max(m, (x + m - 1) // m * m)


_ARANGE = np.empty(0, dtype=np.int64)


def _ar(n: int) -> np.ndarray:
    """Cached arange — build_plan asks for one per front per round, and
    at 1-degree scale the per-call allocations dominated the plan time."""
    global _ARANGE
    if len(_ARANGE) < n:
        _ARANGE = np.arange(max(n, 2 * len(_ARANGE)), dtype=np.int64)
    return _ARANGE[:n]


def _pad_batch(b: int, mult: int = 1) -> int:
    """Pad a round's batch count: powers of two up to 128, multiples of
    128 above (the dummy identity fronts are cheap individually, but a
    power-of-2 jump at large B nearly doubled round-1's transient front
    memory). With ``mult`` = mesh size, rounds with at least ``mult``
    real fronts additionally round up to a multiple of it so their batch
    axis always shards (dummy fronts are cheap at that size). Smaller
    rounds are NOT padded up — measured at 1-degree scale, padding a
    1-2-front tree-top round to the mesh size just multiplies its
    storage by the mesh size for zero per-device gain; those rounds get
    their factor ARRAYS sharded along the front axes instead (see
    JaxMultifrontal._shard_factors)."""
    if b >= 128:
        p = _round_up(b, 128)
    else:
        p = 1
        while p < b:
            p *= 2
    return _round_up(p, mult) if mult > 1 and b >= mult else p


def _pad_dim(x: int) -> int:
    """Pad a front dimension to a bucketed size: powers of two up to 512
    (maximizes compiled-kernel reuse across rounds and matrices — compile
    time is a first-order cost of a cold factorization), multiples of 128
    above that (large fronts dominate memory; power-of-2 padding there
    wastes up to 2x device memory for little compile-cache benefit)."""
    if x <= 8:
        return 8
    if x >= 512:
        return _round_up(x, LANE)
    p = 8
    while p < x:
        p *= 2
    return p


@dataclass
class ChildGroup:
    """All extend-add links from one earlier round into this round,
    batched: dst front [dst_slots[l]] += S_src[src_slots[l]][inv[l]][:, inv[l]]."""
    src_round: int
    src_slots: np.ndarray  # (L,) batch slots in the source round's Schur stack
    dst_slots: np.ndarray  # (L,) batch slots in this round
    inv: np.ndarray        # (L, N) position in child's border (or M_src = pad)


@dataclass
class RoundPlan:
    node_ids: list[int]
    B: int
    P: int                 # padded eliminated size
    N: int                 # padded front size
    M: int                 # N - P (padded border size)
    a_col: np.ndarray      # (B, N, W) ELL front-column per row entry (pad -> 0)
    a_csrc: np.ndarray     # (B, N, W) nzval index per row entry (pad -> nnz: zero)
    a_pos: np.ndarray      # (B, E) SPILL scatter positions into N*N (pad -> N*N)
    a_src: np.ndarray      # (B, E) SPILL indices into CSR nzval (pad -> nnz)
    p_arr: np.ndarray      # (B,) true eliminated count per front (0 for dummies)
    cells_own: np.ndarray  # (B, P) matrix indices of eliminated cells (pad -> flat_len)
    cells_bor: np.ndarray  # (B, M) matrix indices of border cells (pad -> flat_len)
    child_groups: list[ChildGroup]


def build_plan(sym: SymbolicFactorization, matrix: SparseMatrix,
               mem_budget_bytes: float = 1.5e9,
               bytes_per_elem: int = 4,
               batch_multiple: int = 1) -> list[RoundPlan]:
    """Compile the symbolic factorization into static per-round arrays.

    Depends only on the sparsity pattern; reusable across matrices with
    the same pattern (every Newton iteration of a spin-up run).

    Entry routing is fully vectorized: each CSR entry (r, c) is assembled
    exactly once, in the front owning the earlier-eliminated of the two
    cells (if that is c, the entry lands in the owned-column block; if r,
    in the owned-row x border block) — the standard multifrontal assembly
    rule expressed as array ops over all nnz at once.
    """
    # NK_MEM_BUDGET: front-stack transient budget override (bytes). Used
    # by the scaled multichip dryrun to force multi-chunk rounds at small
    # problem sizes; also the production knob for devices with less
    # memory than the 1.5 GB default assumes. The budget changes the plan
    # (chunk boundaries), so factor checkpoints key on the plan count.
    mem_budget_bytes = float(_os.environ.get("NK_MEM_BUDGET",
                                             mem_budget_bytes))
    flat_len = sym.flat_len
    csr_rowptr = np.asarray(matrix.rowptr)
    csr_colind = np.asarray(matrix.colind, dtype=np.int64)
    nnz = len(csr_colind)
    # int32 routing/scatter-index safety: plan_entries and a_src narrow to
    # int32, and the assembly scatter runs with promise_in_bounds — an
    # overflowed index would be silent corruption, so refuse loudly
    if flat_len >= 2 ** 31 or nnz >= 2 ** 31:
        raise ValueError(f"matrix too large for the int32 plan path "
                         f"(flat_len={flat_len}, nnz={nnz} must be < 2^31)")
    # the promise_in_bounds + unique_indices assembly scatter is only safe
    # for canonical CSR (column-sorted, duplicate-free rows — what
    # assemble.py::to_csr emits); a hand-made matrix file with duplicate
    # (r, c) entries would silently corrupt the factors. O(nnz) check.
    if nnz > 1:
        starts = np.zeros(nnz, dtype=bool)
        starts[csr_rowptr[1:-1]] = True
        if not np.all((np.diff(csr_colind) > 0) | starts[1:]):
            raise ValueError(
                "matrix CSR is not canonical (columns not strictly "
                "increasing within rows; duplicates?) — re-canonicalize "
                "with ops.assemble.to_csr before factorization")

    # --- global per-cell tables -------------------------------------------
    cell_node = np.empty(flat_len, dtype=np.int64)   # owning node per cell
    cell_elim = np.empty(flat_len, dtype=np.int64)   # elimination position
    for nid, f in sym.fronts.items():
        cell_node[f.cells[:f.p]] = nid
        # per-cell elimination position: order within the permutation
    cell_elim[sym.perm] = np.arange(flat_len)

    # --- route every CSR entry to its assembly front, grouped per front.
    # Native path: one fused C routing + counting sort (plan_entries);
    # fallback: the same grouping via numpy argsort.
    from ..native import plan_entries
    pe = plan_entries(csr_rowptr, csr_colind, cell_node, cell_elim,
                      len(sym.fronts))
    if pe is not None:
        ent_row, ent_col, ent_src, bounds = pe
    else:
        rows = np.repeat(np.arange(flat_len, dtype=np.int64),
                         np.diff(csr_rowptr))
        col_first = cell_elim[csr_colind] <= cell_elim[rows]
        entry_node = np.where(col_first, cell_node[csr_colind],
                              cell_node[rows])
        order = np.argsort(entry_node, kind="stable")
        bounds = np.searchsorted(entry_node[order],
                                 np.arange(len(sym.fronts) + 1))
        ent_row = rows[order].astype(np.int32)
        ent_col = csr_colind[order].astype(np.int32)
        ent_src = order.astype(np.int32)

    # split each dependency round into memory-bounded, size-homogeneous
    # chunks: fronts sorted by size so each chunk's padding is tight, and
    # the REAL transient allocation — padded batch x (padded max P + padded
    # max M)^2 — stays under the budget (large rounds at 1-degree scale
    # would otherwise materialize tens of GB at once)
    chunked_rounds: list[list[int]] = []
    for node_ids in sym.rounds:
        by_size = sorted(node_ids, key=lambda nid: -sym.fronts[nid].n)
        chunk: list[int] = []
        maxp = maxm = 0
        for nid in by_size:
            f = sym.fronts[nid]
            p2 = max(maxp, f.p)
            m2 = max(maxm, f.n - f.p)
            n_pad = _pad_dim(p2) + (_pad_dim(m2) if m2 > 0 else 0)
            cost = (_pad_batch(len(chunk) + 1, batch_multiple)
                    * n_pad * n_pad * bytes_per_elem)
            if chunk and cost > mem_budget_bytes:
                chunked_rounds.append(chunk)
                chunk, maxp, maxm = [], 0, 0
            chunk.append(nid)
            maxp = max(maxp, f.p)
            maxm = max(maxm, f.n - f.p)
        if chunk:
            chunked_rounds.append(chunk)

    plans: list[RoundPlan] = []
    slot_of_node: dict[int, tuple[int, int]] = {}
    # flat scratch of padded front positions per cell: one write + gathers
    # per front instead of argsort+searchsorted (gx1-scale hot spot).
    # int32: positions < padded max front (~2^15), and the narrower
    # gathers halve traffic on this bandwidth-starved host
    cell_fpos = np.empty(flat_len, dtype=np.int32)
    for rnd, node_ids in enumerate(chunked_rounds):
        B_real = len(node_ids)
        # pad the batch as well: dummy identity fronts cost almost nothing
        # individually and make (B, P, N) shapes reusable across chunks
        # and problem sizes
        B = _pad_batch(B_real, batch_multiple)
        maxp = max(sym.fronts[nid].p for nid in node_ids)
        maxm = max(sym.fronts[nid].n - sym.fronts[nid].p for nid in node_ids)
        P = _pad_dim(maxp)
        M = _pad_dim(maxm) if maxm > 0 else 0
        N = P + M
        pos_l: list[np.ndarray] = [np.empty(0, np.int32)] * B
        src_l: list[np.ndarray] = [np.empty(0, np.int32)] * B
        cells_own = np.full((B, P), flat_len, dtype=np.int64)
        cells_bor = np.full((B, M), flat_len, dtype=np.int64)
        p_arr = np.zeros(B, dtype=np.int32)
        links: list[tuple[int, int, int, np.ndarray]] = []
        for b, nid in enumerate(node_ids):
            f = sym.fronts[nid]
            slot_of_node[nid] = (rnd, b)
            p, n = f.p, f.n
            p_arr[b] = p
            cells_own[b, :p] = f.cells[:p]
            if n > p:
                cells_bor[b, :n - p] = f.cells[p:]
            # padded front position per cell, via flat scratch gather
            cell_fpos[f.cells[:p]] = _ar(p)
            cell_fpos[f.cells[p:]] = P + _ar(n - p)

            s0, s1 = bounds[nid], bounds[nid + 1]
            if s1 > s0:
                rp = cell_fpos[ent_row[s0:s1]]
                cp = cell_fpos[ent_col[s0:s1]]
                # int32 arithmetic: rp*N+cp < padded_N^2 <= ~5e8 < 2^31
                pos_l[b] = rp * np.int32(N) + cp
                src_l[b] = ent_src[s0:s1]
            for ch in f.children:
                cf = sym.fronts[ch]
                src_rnd, src_slot = slot_of_node[ch]
                # capture the parent-front positions NOW (cell_fpos is
                # overwritten by later fronts sharing border cells); the
                # (L, N) inv matrices are built batched per group below
                q = cell_fpos[cf.cells[cf.p:]]
                links.append((src_rnd, src_slot, b, q))
        # Assembly routing, hybrid ELL + spill (ELLPACK form): most
        # entries pack into a per-row rectangle (B, N, W) consumed by the
        # gather/compare assembly kernel — a fused, bandwidth-bound
        # reduce with NO device scatter (the scatter was 31% of the
        # factor at gx3 even with unique+in-bounds promises). W is the
        # 98th-percentile row population of the chunk rounded up to a
        # power of two (shape-bucket reuse); the tail rows' overflow
        # entries spill to the old unique-index scatter, whose cost is
        # negligible at spill sizes. ELL pads: col 0 + the nzval
        # sentinel zero (adds 0.0 to column 0).
        cnts = []
        for b in range(B):
            if len(pos_l[b]):
                cnts.append(np.bincount(pos_l[b] // N, minlength=N))
            else:
                cnts.append(np.zeros(N, dtype=np.int64))
        allc = np.concatenate(cnts)
        occupied = allc[allc > 0]
        if occupied.size:
            w98 = int(np.quantile(occupied, 0.98))
            W = 1 << max(2, int(np.ceil(np.log2(max(w98, 1)))))
        else:
            W = 4
        a_col = np.zeros((B, N, W), dtype=np.int32)
        a_csrc = np.full((B, N, W), nnz, dtype=np.int32)
        spill_pos: list[np.ndarray] = [np.empty(0, np.int32)] * B
        spill_src: list[np.ndarray] = [np.empty(0, np.int32)] * B
        for b in range(B):
            pos, src = pos_l[b], src_l[b]
            if not len(pos):
                continue
            order = np.argsort(pos, kind="stable")
            pos, src = pos[order], src[order]
            rp = pos // N
            cnt = cnts[b]
            starts = np.cumsum(cnt) - cnt
            slot = _ar(len(pos)) - starts[rp].astype(np.int32)
            ell = slot < W
            a_col[b, rp[ell], slot[ell]] = (pos[ell] % N).astype(np.int32)
            a_csrc[b, rp[ell], slot[ell]] = src[ell]
            if not ell.all():
                spill_pos[b] = pos[~ell]
                spill_src[b] = src[~ell]
        E = max(max((len(x) for x in spill_pos), default=0), 1)
        # spill padding entries point at DISTINCT overflow slots past N*N
        # (the scatter buffer is N*N + E and gets truncated): every
        # scatter index is unique and in-bounds, so the device scatter
        # runs with unique_indices + promise_in_bounds (a scatter XLA
        # cannot prove duplicate-free needs atomics or serialization)
        if N * N + E >= 2 ** 31:
            raise ValueError(f"padded front {N}x{N} + {E} entries overflows "
                             f"the int32 scatter index space")
        a_pos = np.tile(N * N + np.arange(E, dtype=np.int32), (B, 1))
        a_src = np.full((B, E), nnz, dtype=np.int32)
        for b in range(B):
            a_pos[b, :len(spill_pos[b])] = spill_pos[b]
            a_src[b, :len(spill_src[b])] = spill_src[b]
        groups: list[ChildGroup] = []
        for src_rnd in sorted({l[0] for l in links}):
            sel = [l for l in links if l[0] == src_rnd]
            M_src = plans[src_rnd].M
            L = len(sel)
            qs = [l[3] for l in sel]
            lens = np.array([len(q) for q in qs], dtype=np.int64)
            inv = np.full((L, N), M_src, dtype=np.int32)
            if lens.sum():
                rowidx = np.repeat(_ar(L), lens)
                qcat = np.concatenate(qs)
                total = int(lens.sum())
                offs = _ar(total) - np.repeat(np.cumsum(lens) - lens, lens)
                inv[rowidx, qcat] = offs.astype(np.int32)
            groups.append(ChildGroup(
                src_round=src_rnd,
                src_slots=np.array([l[1] for l in sel], dtype=np.int32),
                dst_slots=np.array([l[2] for l in sel], dtype=np.int32),
                inv=inv))
        plans.append(RoundPlan(
            node_ids=list(node_ids), B=B, P=P, N=N, M=M,
            a_col=a_col, a_csrc=a_csrc, a_pos=a_pos, a_src=a_src,
            p_arr=p_arr,
            cells_own=cells_own, cells_bor=cells_bor, child_groups=groups))
    return plans


# --------------------------------------------------------------------------
# jitted kernels (shapes static per round; cached across rounds/matrices)
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("N", "P", "spill"))
def _assemble(nzval_ext, a_col, a_csrc, a_pos, a_src, p_arr,
              N: int, P: int, spill: bool = True):
    """Gather-form (ELLPACK) front assembly plus a tiny spill scatter.

    The bulk is F[b, r, c] = sum_w vals[b, r, w] * (col[b, r, w] == c),
    formed as an ELL scatter-add into a zero front. It is exact: each
    (b, r, c) receives at most one ELL contribution (front columns are
    unique per row; ELL pads add 0.0 to column 0).
    Rows wider than the ELL width spill to the unique-index scatter
    (build_plan bounds spills to the 2% tail). Identity padding lands on
    unused pivot-diagonal positions."""
    vals = nzval_ext[a_csrc]                        # (B, R, W)
    B, R, W = a_col.shape
    bi = jnp.arange(B, dtype=jnp.int32)[:, None, None]
    ri = jnp.arange(R, dtype=jnp.int32)[None, :, None]
    F = jnp.zeros((B, R, N), nzval_ext.dtype).at[
        bi, ri, a_col].add(vals, mode="promise_in_bounds")
    if spill:
        E = a_pos.shape[1]

        def one(Fb, pos, src):
            buf = jnp.concatenate([Fb.reshape(-1),
                                   jnp.zeros((E,), nzval_ext.dtype)])
            buf = buf.at[pos].add(nzval_ext[src], mode="promise_in_bounds",
                                  unique_indices=True)
            return buf[:N * N].reshape(N, N)

        F = jax.vmap(one)(F, a_pos, a_src)
    ar = jnp.arange(P)
    eye = (ar[None, :] >= p_arr[:, None]).astype(F.dtype)
    return F.at[:, ar, ar].add(eye)


def _ea_chunk_len(N: int, Mp1: int, itemsize: int) -> int:
    """Link-chunk length of _extend_add's (Lc, N, M+1) temporaries
    (~0.5 GB)."""
    return max(1, int(5e8 / (itemsize * N * Mp1)))


@functools.partial(jax.jit, donate_argnums=(0,))
def _extend_add(F, S_src, src_slots, dst_slots, inv):
    """Batched extend-add of one source round's Schur complements:
    F[dst_slots[l]] += S_src[src_slots[l]][inv[l]][:, inv[l]], with S padded
    by a zero row/column so out-of-front positions contribute nothing.
    Duplicate dst slots (a front with several children in the same source
    round) accumulate through the scatter-add.

    The row selection is a major-axis gather, the column selection a
    take_along_axis gather: pure data movement. (A one-hot selection GEMM
    does the same job in L*N^2*M flops; it measured ~9x slower on the
    H100, PERF.md.) On the GPU, destinations with 3+ contributions add
    atomically in no fixed order: results are exact to rounding of the
    sum, not bit-reproducible."""
    Mp1 = S_src.shape[1] + 1
    L = src_slots.shape[0]
    N = inv.shape[1]
    Sp = jnp.pad(S_src, ((0, 0), (0, 1), (0, 1)))
    # chunk over links so the (Lc, N, M+1) temporaries stay bounded
    # (~0.5 GB) — at gx3deep-scale rounds the unchunked temporaries were
    # several GB on top of the resident factors
    Lc = _ea_chunk_len(N, Mp1, F.dtype.itemsize)
    for lo in range(0, L, Lc):
        hi = min(lo + Lc, L)
        iv = inv[lo:hi]
        G = Sp[src_slots[lo:hi]]
        rows = jax.vmap(lambda g, i: g[i])(G, iv)        # (Lc, N, M+1)
        idx = jnp.broadcast_to(iv[:, None, :], (hi - lo, N, N))
        adds = jnp.take_along_axis(rows, idx, axis=2)
        F = F.at[dst_slots[lo:hi]].add(adds)
    return F


def _pivoted_panel(Pan, off: int, p_arr, tau=0.0):
    """Factor a tall panel (B, R, T) — rows [off, P), cols [off, off+T) —
    with partial pivoting restricted to fully-summed rows (global row <
    p_arr[b]; identity-padded rows never move). This is the restricted
    pivoting a multifrontal method allows (only fully-summed rows may be
    exchanged), which tames the element growth that unpivoted elimination
    suffers on these transport matrices.

    ``tau`` is the GESP static-pivot threshold (SuperLU_DIST's strategy,
    reference SuperLU_brief_tree.txt:12-14): a selected pivot smaller in
    magnitude than tau = sqrt(eps) * max|A| is replaced by sign * tau.
    These transport Jacobians have near-singular pivot blocks at every
    tree level (zero advective row sums), and unbounded 1/pivot is what
    drove the measured ~1e9 element growth of the float32 factors — the
    O(tau) factorization perturbation is repaid by iterative refinement
    at a fraction of the Krylov cycles the growth used to cost.

    Returns (factored panel, piv sequence (B, T) of panel-relative row
    choices)."""
    B, R, T = Pan.shape
    rows_global = off + jnp.arange(R)
    r_idx = jnp.arange(R)[None, :]

    def body(k, carry):
        Pan, piv = carry
        col = Pan[:, :, k]
        ok = (r_idx >= k) & ((rows_global[None, :] < p_arr[:, None])
                             | (r_idx == k))
        score = jnp.where(ok, jnp.abs(col), -1.0)
        sel = jnp.argmax(score, axis=1)
        bidx = jnp.arange(B)
        rowk = Pan[:, k, :]
        rowsel = Pan[bidx, sel, :]
        Pan = Pan.at[:, k, :].set(rowsel)
        Pan = Pan.at[bidx, sel, :].set(rowk)
        piv = piv.at[:, k].set(sel.astype(jnp.int32))
        pv = Pan[:, k, k][:, None]
        pv = jnp.where(jnp.abs(pv) < tau,
                       jnp.where(pv < 0, -tau, tau), pv)
        Pan = Pan.at[:, k, k].set(pv[:, 0])
        colv = Pan[:, :, k] / pv
        colv = jnp.where(r_idx > k, colv, 0.0)[:, :, None]
        rowv = jnp.where(jnp.arange(T)[None, :] > k, Pan[:, k, :], 0.0)[:, None, :]
        Pan = Pan - colv * rowv
        Pan = Pan.at[:, :, k].set(jnp.where(r_idx > k, colv[:, :, 0],
                                            Pan[:, :, k]))
        return Pan, piv

    piv0 = jnp.zeros((B, T), dtype=jnp.int32)
    return jax.lax.fori_loop(0, T, body, (Pan, piv0))


def _seq_to_perm(piv, R: int):
    """Compose a pivot-swap sequence into a row permutation (B, R):
    perm[b, i] = panel-relative source row that ends up at position i."""
    B, T = piv.shape
    perm = jnp.tile(jnp.arange(R, dtype=jnp.int32)[None, :], (B, 1))

    def body(k, perm):
        sel = piv[:, k]
        bidx = jnp.arange(B)
        a = perm[:, k]
        b = perm[bidx, sel]
        perm = perm.at[:, k].set(b)
        perm = perm.at[bidx, sel].set(a)
        return perm

    return jax.lax.fori_loop(0, T, body, perm)


def _pack_diag_inv(LU, bs: int = PANEL):
    """Replace each bs-sized diagonal block of a packed LU (B, P, P)
    with stril(L_ii^-1, -1) + triu(U_ii^-1); off-diagonal blocks keep the
    raw L/U values. This is the factor layout the solve's block
    substitution (_block_lower_apply/_block_upper_apply) consumes.

    WHY substitution instead of storing the full explicit triangular
    inverses (the round-1 design): on these transport Jacobians the
    P-sized triangles are ill-conditioned (kappa ~ 1e5 at 60 levels,
    growth probe 2026-08-17), and a float32 full inverse carries forward
    error ~ eps32 * kappa — measured as a ~1.5e-2 preconditioner apply
    error that forced ~1.5-digit-per-cycle GMRES-IR refinement. Block
    substitution is backward-stable across blocks (only the bs-wide
    diagonal blocks are inverted, whose conditioning is what a TRSM step
    sees), restoring direct-solver apply accuracy, while every op stays
    a batched GEMM — a triangular_solve over the full P is serial in the
    panel count and latency-poison when the solve is reapplied as a
    Krylov preconditioner.

    The block size trades apply latency (sequential steps = P/bs per
    round, the dominant term of a warm solve dispatch) against apply
    accuracy (error ~ eps32 * kappa(bs-block)); see SOLVE_BS."""
    B, Pdim, _ = LU.shape
    if _use_loop_form(Pdim, bs):
        eye = jnp.eye(bs, dtype=LU.dtype)

        def body(i, out):
            o = i * bs
            Ti = jax.lax.dynamic_slice(out, (0, o, o), (B, bs, bs))
            Li = triangular_solve(Ti, jnp.broadcast_to(eye, (B, bs, bs)),
                                  left_side=True, lower=True,
                                  unit_diagonal=True)
            Ui = triangular_solve(Ti, jnp.broadcast_to(eye, (B, bs, bs)),
                                  left_side=True, lower=False,
                                  unit_diagonal=False)
            Ki = jnp.tril(Li, -1) + jnp.triu(Ui)
            return jax.lax.dynamic_update_slice(out, Ki, (0, o, o))

        return jax.lax.fori_loop(0, Pdim // bs, body, LU)
    out = LU
    for o in range(0, Pdim, bs):
        T = min(bs, Pdim - o)
        Ti = LU[:, o:o + T, o:o + T]
        eye = jnp.eye(T, dtype=LU.dtype)
        Li = triangular_solve(Ti, jnp.broadcast_to(eye, (B, T, T)),
                              left_side=True, lower=True,
                              unit_diagonal=True)
        Ui = triangular_solve(Ti, jnp.broadcast_to(eye, (B, T, T)),
                              left_side=True, lower=False,
                              unit_diagonal=False)
        Ki = jnp.tril(Li, -1) + jnp.triu(Ui)
        out = out.at[:, o:o + T, o:o + T].set(Ki)
    return out


def _mm(a, b):
    """Batched matmul at HIGHEST precision (no reduced-precision passes:
    float32 operands stay float32, never TF32; float64 is native)."""
    return jnp.matmul(a, b, preferred_element_type=b.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def _use_loop_form(Pdim: int, bs: int) -> bool:
    """Unrolled block substitution generates one program region per block
    step; above ~16 steps XLA stops aliasing the step temporaries and the
    compiled program's temp footprint grows linearly in P/bs — at
    1-degree tree-top shapes (P=12032, bs=128, 94 steps) a single
    program wanted ~10x its live state in temporaries. The fori_loop
    forms below carry ONE buffer and bound temps to a step's working
    set; their full-width GEMM steps cost 2x the flops, minor against
    GEMM throughput at these sizes.
    Small step counts keep the unrolled form (solve-latency-critical,
    and XLA aliases them fine)."""
    return Pdim % bs == 0 and Pdim // bs > 16


def _block_lower_apply(K, rhs, bs: int = PANEL):
    """y = L11^-1 rhs by block forward substitution. K is the
    _pack_diag_inv layout (B, P, >=P) — only its leading (P, P) block is
    read; rhs (B, P, nrhs). All slices are static, every op a GEMM."""
    Pdim = rhs.shape[1]
    if _use_loop_form(Pdim, bs):
        B, _, nrhs = rhs.shape
        KD = _extract_diag_blocks(K[:, :, :Pdim], bs)

        def body(i, y):
            o = i * bs
            t = (jax.lax.dynamic_slice(rhs, (0, o, 0), (B, bs, nrhs))
                 - _mm(jax.lax.dynamic_slice(K, (0, o, 0), (B, bs, Pdim)),
                       y))
            kd = jax.lax.dynamic_index_in_dim(KD, i, 1, keepdims=False)
            t = t + _mm(jnp.tril(kd, -1), t)
            return jax.lax.dynamic_update_slice(y, t, (0, o, 0))

        return jax.lax.fori_loop(0, Pdim // bs, body, jnp.zeros_like(rhs))
    ys = []
    for o in range(0, Pdim, bs):
        T = min(bs, Pdim - o)
        t = rhs[:, o:o + T]
        if o:
            t = t - _mm(K[:, o:o + T, :o], jnp.concatenate(ys, axis=1))
        KD = K[:, o:o + T, o:o + T]
        ys.append(t + _mm(jnp.tril(KD, -1), t))
    return jnp.concatenate(ys, axis=1) if len(ys) > 1 else ys[0]


def _block_upper_apply(K, rhs, bs: int = PANEL):
    """x = U11^-1 rhs by block backward substitution (layout as above)."""
    Pdim = rhs.shape[1]
    if _use_loop_form(Pdim, bs):
        B, _, nrhs = rhs.shape
        nblk = Pdim // bs
        KD = _extract_diag_blocks(K[:, :, :Pdim], bs)

        def body(i2, x):
            i = nblk - 1 - i2
            o = i * bs
            t = (jax.lax.dynamic_slice(rhs, (0, o, 0), (B, bs, nrhs))
                 - _mm(jax.lax.dynamic_slice(K, (0, o, 0), (B, bs, Pdim)),
                       x))
            kd = jax.lax.dynamic_index_in_dim(KD, i, 1, keepdims=False)
            t = _mm(jnp.triu(kd), t)
            return jax.lax.dynamic_update_slice(x, t, (0, o, 0))

        return jax.lax.fori_loop(0, nblk, body, jnp.zeros_like(rhs))
    xs = []
    for o in reversed(range(0, Pdim, bs)):
        T = min(bs, Pdim - o)
        t = rhs[:, o:o + T]
        if xs:
            t = t - _mm(K[:, o:o + T, o + T:Pdim],
                        jnp.concatenate(xs, axis=1))
        KD = K[:, o:o + T, o:o + T]
        xs.insert(0, _mm(jnp.triu(KD), t))
    return jnp.concatenate(xs, axis=1) if len(xs) > 1 else xs[0]


def _extract_diag_blocks(K, bs: int):
    """The PANEL diagonal blocks of a packed pivot block K (B, P, P) as a
    replicated stack (B, P//bs, bs, bs) — the masked substitution path
    reads diagonal blocks from here so it never slices K's device-sharded
    column axis."""
    B, Pdim, _ = K.shape
    nblk = Pdim // bs
    blocks = K.reshape(B, nblk, bs, nblk, bs)
    ar = jnp.arange(nblk)
    return jnp.transpose(blocks[:, ar, :, ar], (1, 0, 2, 3))


_extract_diag_blocks_jit = jax.jit(_extract_diag_blocks,
                                   static_argnames=("bs",))


def _block_lower_apply_masked(K, KD, rhs):
    """y = L11^-1 rhs when K's COLUMN axis is device-sharded (front-axis
    rounds, _shard_factors): each step contracts the full-width row block
    K[:, o:o+bs, :] against a zero-padded carry, so GSPMD lowers it to a
    local GEMM + psum over the mesh instead of rematerializing replicated
    K slices (the round-1 XLA reshard warning — an all-gather of GBs of
    tree-top factors per solve). Reads 2x the entries of
    _block_lower_apply, but each device touches only its own 1/ndev
    shard; diagonal blocks come from the replicated KD stack."""
    bs = KD.shape[-1]
    Pdim = rhs.shape[1]
    if _use_loop_form(Pdim, bs):
        B, _, nrhs = rhs.shape
        Kcols = K.shape[2]

        def body(i, y):
            o = i * bs
            t = (jax.lax.dynamic_slice(rhs, (0, o, 0), (B, bs, nrhs))
                 - _mm(jax.lax.dynamic_slice(K, (0, o, 0), (B, bs, Kcols)),
                       y))
            kd = jax.lax.dynamic_index_in_dim(KD, i, 1, keepdims=False)
            t = t + _mm(jnp.tril(kd, -1), t)
            return jax.lax.dynamic_update_slice(y, t, (0, o, 0))

        return jax.lax.fori_loop(0, Pdim // bs, body, jnp.zeros_like(rhs))
    y = jnp.zeros_like(rhs)
    for i, o in enumerate(range(0, Pdim, bs)):
        t = rhs[:, o:o + bs] - _mm(K[:, o:o + bs, :], y)
        t = t + _mm(jnp.tril(KD[:, i], -1), t)
        y = jax.lax.dynamic_update_slice(y, t, (0, o, 0))
    return y


def _block_upper_apply_masked(K, KD, rhs):
    """x = U11^-1 rhs, masked form (layout/sharding as above)."""
    bs = KD.shape[-1]
    Pdim = rhs.shape[1]
    if _use_loop_form(Pdim, bs):
        B, _, nrhs = rhs.shape
        Kcols = K.shape[2]
        nblk = Pdim // bs

        def body(i2, x):
            i = nblk - 1 - i2
            o = i * bs
            t = (jax.lax.dynamic_slice(rhs, (0, o, 0), (B, bs, nrhs))
                 - _mm(jax.lax.dynamic_slice(K, (0, o, 0), (B, bs, Kcols)),
                       x))
            kd = jax.lax.dynamic_index_in_dim(KD, i, 1, keepdims=False)
            t = _mm(jnp.triu(kd), t)
            return jax.lax.dynamic_update_slice(x, t, (0, o, 0))

        return jax.lax.fori_loop(0, nblk, body, jnp.zeros_like(rhs))
    x = jnp.zeros_like(rhs)
    for o in range(Pdim - bs, -1, -bs):
        t = rhs[:, o:o + bs] - _mm(K[:, o:o + bs, :], x)
        t = _mm(jnp.triu(KD[:, o // bs]), t)
        x = jax.lax.dynamic_update_slice(x, t, (0, o, 0))
    return x


def _block_upper_apply_right(K, rhs, bs: int = PANEL):
    """X = rhs @ U11^-1 (right-side solve X U11 = rhs) by block forward
    substitution over column blocks; rhs (B, M, P)."""
    Pdim = rhs.shape[2]
    if _use_loop_form(Pdim, bs):
        B, M, _ = rhs.shape
        KD = _extract_diag_blocks(K[:, :, :Pdim], bs)

        def body(i, x):
            o = i * bs
            t = (jax.lax.dynamic_slice(rhs, (0, 0, o), (B, M, bs))
                 - _mm(x, jax.lax.dynamic_slice(K, (0, 0, o),
                                                (B, Pdim, bs))))
            kd = jax.lax.dynamic_index_in_dim(KD, i, 1, keepdims=False)
            t = _mm(t, jnp.triu(kd))
            return jax.lax.dynamic_update_slice(x, t, (0, 0, o))

        return jax.lax.fori_loop(0, Pdim // bs, body, jnp.zeros_like(rhs))
    xs = []
    for o in range(0, Pdim, bs):
        T = min(bs, Pdim - o)
        t = rhs[:, :, o:o + T]
        if o:
            t = t - _mm(jnp.concatenate(xs, axis=2), K[:, :o, o:o + T])
        KD = K[:, o:o + T, o:o + T]
        xs.append(_mm(t, jnp.triu(KD)))
    return jnp.concatenate(xs, axis=2) if len(xs) > 1 else xs[0]


def _finish_factor(F, lu, perm, P: int, pack_bs: int = PANEL):
    """Shared tail of the partial factorization once the pivot block's
    packed LU and row permutation are known: pack the diagonal-block
    inverses, form U12/L21 by block substitution, Schur-update the
    border.

    The factors are stored as K (B, P, P) — the _pack_diag_inv layout
    (raw off-diagonal L/U blocks, inverted+packed PANEL diagonal blocks)
    — plus U12 (B, P, M) and L21 (B, M, P). K and U12 are SEPARATE
    arrays (not the round-1 concatenated [K | U12]) so a device mesh can
    shard each along the axis its solve GEMM contracts over without the
    solve slicing a sharded axis (see _shard_factors); total resident
    bytes are identical. See _pack_diag_inv for why substitution
    replaced full explicit inverses."""
    N = F.shape[-1]
    K = _pack_diag_inv(lu, pack_bs)
    bord = N - P
    if bord > 0:
        F12p = jnp.take_along_axis(F[:, :P, P:], perm[:, :, None], axis=1)
        U12 = _block_lower_apply(K, F12p, pack_bs)
        L21 = _block_upper_apply_right(K, F[:, P:, :P], pack_bs)
        S = F[:, P:, P:] - _mm(L21, U12)
    else:
        U12 = jnp.zeros((F.shape[0], P, 0), dtype=F.dtype)
        L21 = jnp.zeros((F.shape[0], 0, P), dtype=F.dtype)
        S = jnp.zeros((F.shape[0], 0, 0), dtype=F.dtype)
    return K, U12, L21, S, perm


def _partial_factor_small_batch(F, P: int, tau, pack_bs: int = PANEL):
    """Root-of-tree rounds (tiny batch, large pivot block): XLA's native
    LU (a LAPACK/cuSOLVER getrf, float32 or float64) beats the hand-blocked
    panel loop there (which is latency-bound in its sequential column
    steps), while at large batch the native LU runs per matrix — hence
    the B<=2 gate in _partial_factor_body.

    Unrestricted partial pivoting within F11 is exactly the multifrontal
    restriction: border rows are outside the block, and the identity
    padding forms a decoupled diagonal block that pivoting provably never
    mixes with real rows (padding rows are zero in real columns).

    GESP pivot thresholding (see _pivoted_panel) is applied POST-HOC to
    U's diagonal: with partial pivoting every L multiplier is <= 1, so
    clamping U_kk to sign * tau afterwards perturbs L@U by at most tau
    per entry — the same O(tau) backward error as thresholding inside
    the elimination."""
    lu, piv, perm = jax.lax.linalg.lu(F[:, :P, :P])
    ar = jnp.arange(P)
    d = lu[:, ar, ar]
    d = jnp.where(jnp.abs(d) < tau, jnp.where(d < 0, -tau, tau), d)
    lu = lu.at[:, ar, ar].set(d)
    return _finish_factor(F, lu, perm.astype(jnp.int32), P, pack_bs)


def _partial_factor_body(F, P: int, p_arr, tau=0.0,
                         allow_native_lu: bool = True,
                         pack_bs: int = PANEL):
    """Blocked LU with restricted partial pivoting of F[:, :P, :P]; TRSM of
    the off-blocks; Schur update.

    The sequential pivoted panel step is the XLA column loop
    _pivoted_panel; the trailing updates are _mm GEMMs.

    Returns (K, U12, L21, S, perm) — see _finish_factor for the layout
    rationale; S = F22 - L21 @ U12; perm (B, P) maps solve positions to
    original eliminated-row order (border rows are never permuted). Only
    these blocks survive — the factored border x border quadrant is dead
    weight for the solve and the full (B, N, N) front exists only
    transiently inside this program.
    """
    N = F.shape[-1]
    B = F.shape[0]
    tau = jnp.asarray(tau, F.dtype)
    if B <= 2 and allow_native_lu:
        # unsharded tree-top rounds only: XLA's LU custom call has no
        # GSPMD partitioning rule, so under a mesh the hand-blocked path
        # below (purely batch-elementwise ops + GEMMs) keeps the round
        # sharded instead of all-gathering the biggest fronts
        return _partial_factor_small_batch(F, P, tau, pack_bs)
    perm_total = jnp.tile(jnp.arange(P, dtype=jnp.int32)[None, :], (B, 1))
    nb = (P + PANEL - 1) // PANEL
    for t in range(nb):
        off = t * PANEL
        T = min(PANEL, P - off)
        R = P - off
        Pan = jax.lax.dynamic_slice(F, (0, off, off), (B, R, T))
        Pan, piv = _pivoted_panel(Pan, off, p_arr, tau)
        pperm = _seq_to_perm(piv, R)
        # permute the panel rows' other columns, then write the factored
        # panel into place
        Rows = jax.lax.dynamic_slice(F, (0, off, 0), (B, R, N))
        Rows = jnp.take_along_axis(Rows, pperm[:, :, None].astype(jnp.int32),
                                   axis=1)
        Rows = jax.lax.dynamic_update_slice(Rows, Pan, (0, 0, off))
        F = jax.lax.dynamic_update_slice(F, Rows, (0, off, 0))
        seg = jax.lax.dynamic_slice(perm_total, (0, off), (B, R))
        seg = jnp.take_along_axis(seg, pperm, axis=1)
        perm_total = jax.lax.dynamic_update_slice(perm_total, seg, (0, off))

        rest = N - off - T
        if rest > 0:
            D = Pan[:, :T, :T]
            # U-part of the panel rows
            A12 = jax.lax.dynamic_slice(F, (0, off, off + T), (B, T, rest))
            A12 = triangular_solve(D, A12, left_side=True, lower=True,
                                   unit_diagonal=True)
            F = jax.lax.dynamic_update_slice(F, A12, (0, off, off + T))
            # L-part of the (never-permuted) border rows
            bord = N - P
            if bord > 0:
                A21b = jax.lax.dynamic_slice(F, (0, P, off), (B, bord, T))
                A21b = triangular_solve(D, A21b, left_side=False, lower=False,
                                        unit_diagonal=False)
                F = jax.lax.dynamic_update_slice(F, A21b, (0, P, off))
            # trailing update (HIGHEST precision — a direct solver cannot
            # afford reduced-precision matmul passes)
            Lrows = jax.lax.dynamic_slice(F, (0, off + T, off),
                                          (B, N - off - T, T))
            A22 = jax.lax.dynamic_slice(F, (0, off + T, off + T),
                                        (B, rest, rest))
            A22 = A22 - _mm(Lrows, A12)
            F = jax.lax.dynamic_update_slice(F, A22, (0, off + T, off + T))
    S = F[:, P:, P:]
    # pack the pivot block for the solve's block substitution: only the
    # PANEL diagonal blocks are inverted (see _pack_diag_inv for the
    # accuracy rationale); U12/L21 were already TRSM'd in place by the
    # panel loop. Layout matches _finish_factor (split K / U12).
    K = _pack_diag_inv(F[:, :P, :P], pack_bs)
    return K, F[:, :P, P:], F[:, P:, :P], S, perm_total


_partial_factor = jax.jit(_partial_factor_body,
                          static_argnames=("P", "allow_native_lu",
                                           "pack_bs"))


def _set_own(W, vals, cells_own):
    """Write vals (B, P, nrhs) to W rows cells_own (a scatter-set; a
    full-length gather rebuild measured no faster on the H100)."""
    flat = vals.reshape(-1, vals.shape[-1])
    return W.at[cells_own.reshape(-1)].set(flat, mode="drop")


def _fwd_round(W, K, U12, L21, perm, KD, cells_own, cells_bor,
               bs: int = PANEL, hi: bool = False):
    """Forward substitution for one round, batched over fronts: block
    substitution against the packed pivot block (_pack_diag_inv layout).
    A non-None KD (replicated diagonal-block stack) selects the masked
    substitution that keeps column-sharded K local to each device.

    ``hi``: run this round's substitution arithmetic in float64
    (factors stay float32 in memory; they are upcast transiently). The
    tree-top rounds are where element growth concentrates, and the
    sequential block chain there ACCUMULATES eps32 apply error — f64
    arithmetic removes the accumulation term, leaving only the factor
    storage rounding, which refinement absorbs in fewer cycles. Cheap:
    top rounds are small-batch and the apply is O(P^2 nrhs).

    W is (flat_len+1, nrhs) with a trailing dump row for padding."""
    rhs = W[cells_own]                                  # (B, P, nrhs)
    rhs = jnp.take_along_axis(rhs, perm[:, :, None], axis=1)
    if hi:
        rhs = rhs.astype(jnp.float64)
        K = K.astype(jnp.float64)
        L21 = L21.astype(jnp.float64)
        KD = KD.astype(jnp.float64) if KD is not None else None
    y = (_block_lower_apply_masked(K, KD, rhs) if KD is not None
         else _block_lower_apply(K, rhs, bs))
    upd = _mm(L21, y)
    if hi:
        y = y.astype(W.dtype)
        upd = upd.astype(W.dtype)
    W = _set_own(W, y, cells_own)
    W = W.at[cells_bor.reshape(-1)].add(-upd.reshape(-1, y.shape[-1]),
                                        mode="drop")
    return W


def _bwd_round(W, K, U12, L21, KD, cells_own, cells_bor,
               bs: int = PANEL, hi: bool = False):
    """Backward substitution: x = U11^-1 (rhs - U12 xb), by block
    substitution on the packed pivot block (``hi``: see _fwd_round)."""
    rhs = W[cells_own]
    xb = W[cells_bor]
    if hi:
        rhs = rhs.astype(jnp.float64)
        xb = xb.astype(jnp.float64)
        K = K.astype(jnp.float64)
        U12 = U12.astype(jnp.float64)
        KD = KD.astype(jnp.float64) if KD is not None else None
    rhs = rhs - _mm(U12, xb)
    x = (_block_upper_apply_masked(K, KD, rhs) if KD is not None
         else _block_upper_apply(K, rhs, bs))
    if hi:
        x = x.astype(W.dtype)
    return _set_own(W, x, cells_own)


def _solve_rounds(W, factors, flat_consts, bs: int, hi: tuple):
    """The whole triangular sweep: forward through every round, then
    backward. A module-level function with static (bs, hi), so a compiled
    solve program holds no reference to the engine whose factors it is
    passed."""
    for rnd in range(len(hi)):
        K, U12, L21, perm, KD = factors[rnd]
        own, bor = flat_consts[rnd]
        W = _fwd_round(W, K, U12, L21, perm, KD, own, bor, bs=bs, hi=hi[rnd])
    for rnd in range(len(hi) - 1, -1, -1):
        K, U12, L21, perm, KD = factors[rnd]
        own, bor = flat_consts[rnd]
        W = _bwd_round(W, K, U12, L21, KD, own, bor, bs=bs, hi=hi[rnd])
    return W


_solve_rounds_jit = jax.jit(_solve_rounds, static_argnames=("bs", "hi"),
                            donate_argnums=(0,))


class JaxMultifrontal:
    """Device numeric engine. Factorization runs as bucket-shaped per-chunk
    kernels (compiled shapes reused across chunks and matrices); the whole
    forward+backward triangular sweep is ONE compiled program per nrhs — a
    single device dispatch per solve.

    With ``mesh`` given, the front batch of every round is sharded over the
    mesh's leading axis: plan constants are device_put with a NamedSharding
    and GSPMD propagates the sharding through assembly, extend-add (whose
    cross-round Schur gathers become the inter-device traffic — the mesh
    form of SuperLU_DIST's L/U panel distribution over the nprow x npcol
    grid, reference solve_ABglobal.c:307), the batched partial factor, and
    the level-wave triangular solves. Rounds whose batch does not divide
    the mesh stay replicated (the top-of-tree fronts, where batch
    parallelism has run out anyway)."""

    def __init__(self, sym: SymbolicFactorization, matrix: SparseMatrix,
                 precision=None, mesh=None, mesh_axis: str | None = None,
                 checkpoint_dir: str | None = None, factorize: bool = True,
                 factor_only: bool = False):
        self.sym = sym
        self.mesh = mesh
        self._ckpt_dir = checkpoint_dir
        self.mesh_axis = mesh_axis or (mesh.axis_names[0] if mesh is not None
                                       else None)
        self.platform = platform()
        if precision is None:
            # float64 factors on every backend (the reference's precision:
            # float32 factors are a knife's edge at these elimination
            # growth rates); float32 only when x64 is off
            precision = (jnp.float64 if jax.config.jax_enable_x64
                         else jnp.float32)
        self.prec = precision
        if (self.prec == jnp.float64
                and not jax.config.jax_enable_x64):
            # without x64, jnp silently downcasts every float64 array to
            # float32 — the engine would "run in f64" while computing f32
            raise ValueError(
                "precision=float64 requires jax_enable_x64=True "
                "(jax.config.update('jax_enable_x64', True))")
        setup_compile_cache()
        # see _factor_body: serialize chunk programs on simulated meshes
        self._sync_rounds = mesh is not None and self.platform == "cpu"
        # solve-side packed-inverse block size (SOLVE_BS): mesh engines
        # pin PANEL so the masked substitution's KD stack and the
        # sharded-round checkpoint layout stay uniform; single-device
        # engines pick it adaptively AFTER the plans exist (below)
        self._pack_bs = PANEL if mesh is not None else max(PANEL, SOLVE_BS)
        # factor offload (out-of-core numeric phase): with a round
        # checkpointer attached, each completed round's factor arrays are
        # DROPPED from memory right after they persist — later factor
        # rounds consume only Schur stacks, never factors — and streamed
        # back once the transients are gone. Cuts the factor-phase peak
        # from factors-so-far + live Schur + front stacks to
        # live Schur + front stacks (the 2026-08-18 gx1 simulated-mesh
        # run OOM-killed this host at 127 GB without it: all 8 virtual
        # devices' shards share one address space).
        self._offload = (checkpoint_dir is not None
                         and _os.environ.get("NK_FACTOR_OFFLOAD",
                                             "1") != "0")
        ndev_plan = (mesh.shape[self.mesh_axis] if mesh is not None else 1)
        with timed("build round plans"):
            self.plans = build_plan(sym, matrix, batch_multiple=ndev_plan)
        if mesh is None and SOLVE_BS == 0:
            # adaptive solve block size: the apply's sequential critical
            # path is sum(ceil(P/bs)) block steps, its error ~ eps32 x
            # kappa(bs-block) — and the block conditioning that matters
            # tracks element growth, which scales with elimination-tree
            # depth (~max front size). Shallow trees (gx3-class) take
            # FULL explicit inverses (bs = maxP): one GEMM per round in
            # the apply AND one triangular-solve pair per round in
            # _pack_diag_inv, at the same residual class. The 60-level
            # production class keeps 512 (full inverses' eps32 * kappa
            # apply error stalls float32 refinement at depth). Re-tuning
            # for the GPU is open. NK_SOLVE_BS overrides.
            maxP = max((p.P for p in self.plans), default=PANEL)
            if maxP <= 2048:
                self._pack_bs = maxP
            elif maxP <= 4096:
                self._pack_bs = 1024
            else:
                self._pack_bs = 512
        from .memplan import plan_memory
        ndev = (self.mesh.shape[self.mesh_axis]
                if self.mesh is not None else 1)
        dbg(1, "memory plan: " + plan_memory(
            self.plans, ndev,
            np.dtype(self.prec).itemsize).summary())
        self.flat_len = sym.flat_len
        # factor-only mode (NK_FACTOR_ONLY=1): produce/extend the per-round
        # factor CHECKPOINTS and stop — never stream the full factor set
        # back into device memory and never solve. This is the
        # small-device-memory configuration: one device can factor a
        # problem whose complete factors (tens of GB) only ever exist on
        # the host disk; the solve runs elsewhere (e.g. the multi-device
        # mesh) by resuming from the same checkpoint directory. Rounds
        # already checkpointed need no plan constants at all (they are
        # neither assembled nor extend-added), so their device uploads are
        # skipped outright.
        self._factor_only = (factor_only
                             or _os.environ.get("NK_FACTOR_ONLY") == "1")
        # NK_FACTOR_STOP_AFTER=R: process rounds 0..R then stop — the
        # cross-device handoff point (e.g. memory-bound mid-tree repair on
        # the big-RAM host, tree-top rounds on the device). The on-disk
        # checkpoint state is resumable at every completed round, so the
        # next engine pointed at the directory continues from R+1.
        stop = _os.environ.get("NK_FACTOR_STOP_AFTER")
        self._stop_after = int(stop) if stop else None
        if self._stop_after is not None and not self._factor_only:
            raise ValueError("NK_FACTOR_STOP_AFTER requires factor-only "
                             "mode (a partial factor set cannot solve)")
        self._skip_consts: set[int] = set()
        if self._factor_only and self._ckpt_dir is not None:
            ck = self._ckpt_for(matrix)
            self._skip_consts = self._scan_done(ck)
        with timed("device constants"):
            self._consts = self._device_constants()
        # the numeric phase dispatches per chunk (not one fused program):
        # bucketed kernels are shared across chunks AND problem sizes, and
        # eager Schur frees bound peak memory exactly
        if factorize:
            self._factorize(matrix)
        else:
            # deferred numeric phase: the caller loads persisted factors
            # (checkpoint.load_factors) or refactor()s explicitly
            self.factors = None
            self._ckpt = None

    def _put(self, arr, batch: int | None):
        """Device placement honoring the mesh: shard dim 0 over the mesh
        axis when the batch divides it, replicate otherwise (and always
        when single-device)."""
        if self.mesh is None:
            return jnp.asarray(arr)
        from jax.sharding import NamedSharding, PartitionSpec
        ndev = self.mesh.shape[self.mesh_axis]
        nd = np.ndim(arr)
        if batch is not None and batch % ndev == 0:
            spec = PartitionSpec(self.mesh_axis, *([None] * (nd - 1)))
        else:
            spec = PartitionSpec(*([None] * nd))
        return jax.device_put(np.asarray(arr), NamedSharding(self.mesh, spec))

    def _put_rhs(self, W):
        """Stage a solve workspace (flat_len+1, nrhs): sharded over the
        mesh's "rhs" axis when one exists and divides nrhs (data-parallel
        multi-RHS — the device-mesh form of get_B_dist, parallel/mesh.py),
        else replicated. Every per-round gather/GEMM of the solve program is
        batch-parallel in the RHS axis, so the rhs-sharded program runs
        with no collectives at all."""
        if self.mesh is None:
            return jnp.asarray(W)
        from jax.sharding import NamedSharding, PartitionSpec
        nrhs = W.shape[1]
        if "rhs" in self.mesh.axis_names \
                and nrhs % self.mesh.shape["rhs"] == 0:
            spec = PartitionSpec(None, "rhs")
        else:
            spec = PartitionSpec(None, None)
        return jax.device_put(np.asarray(W), NamedSharding(self.mesh, spec))

    # big-front rounds with fewer real fronts than devices shard their
    # factor ARRAYS along a front axis instead of the batch axis — the
    # mesh form of SuperLU_DIST distributing one supernode's L/U panels
    # over the whole process grid (solve_ABglobal.c:307). The solve-path
    # GEMMs then contract over the sharded axis (GSPMD inserts the psum:
    # a distributed GEMM over the device interconnect); the factor COMPUTE
    # of these rounds stays replicated (same wall-clock as the
    # pre-sharding design, and their transient (B,N,N) working set is
    # budget-bounded) but the RESIDENT factors — the 1-degree problem's ~16 GB/device of
    # replicated tree-top L/U — drop by the mesh size.
    ROW_SHARD_MIN = 1024

    def _row_sharded(self, plan) -> bool:
        if self.mesh is None:
            return False
        ndev = self.mesh.shape[self.mesh_axis]
        return (plan.B % ndev != 0 and plan.N >= self.ROW_SHARD_MIN
                and plan.N % ndev == 0)

    def _shard_factors(self, plan, K, U12, L21):
        """Apply front-axis shardings to one round's stored factors.

        Each array is sharded along the axis its solve GEMM contracts
        over, so GSPMD lowers every solve-side op to a local GEMM + psum
        with NO resharding of the stored factors (the round-1 design
        stored [K | U12] concatenated and the solve's static slices of
        the sharded axis forced XLA to rematerialize replicated copies
        every solve — the reshard warning in BENCH_NOTES):
          K   (B, P, P): columns sharded; consumed masked (KD holds the
              replicated diagonal blocks so no sharded-axis slicing).
          U12 (B, P, M): border axis sharded — contracts against xb.
          L21 (B, M, P): row axis M sharded — output psum-free, the
              (B, M, nrhs) update is all-gathered into W (the
              information-theoretic minimum traffic for that step).
        Returns (K, U12, L21, KD); KD is None off the masked path."""
        if not self._row_sharded(plan):
            return K, U12, L21, None
        from jax.sharding import NamedSharding, PartitionSpec as PS
        ndev = self.mesh.shape[self.mesh_axis]

        def put(x, axis_size, spec):
            if axis_size % ndev != 0 or axis_size == 0:
                return None
            s = NamedSharding(self.mesh, spec)
            if isinstance(x, jax.core.Tracer):
                return jax.lax.with_sharding_constraint(x, s)
            return jax.device_put(x, s)

        KD = None
        bs = min(PANEL, plan.P)
        if plan.P % ndev == 0 and plan.P % bs == 0:
            KD = _extract_diag_blocks_jit(K, bs=bs)
            Ks = put(K, plan.P, PS(None, None, self.mesh_axis))
            if Ks is not None:
                K = Ks
            else:
                KD = None       # replicated K: plain substitution path
        if plan.M:
            U12s = put(U12, plan.M, PS(None, None, self.mesh_axis))
            if U12s is not None:
                U12 = U12s
            L21s = put(L21, plan.M, PS(None, self.mesh_axis, None))
            if L21s is not None:
                L21 = L21s
        return K, U12, L21, KD

    def _shard_schur(self, plan, S):
        """The Schur stacks of row-sharded rounds accumulate across the
        whole tree-top chain (a 1-degree root-path stack is 1-3 GB each)
        — shard their trailing axis so the live set distributes; the
        consuming extend-add reshards as GSPMD requires."""
        if not self._row_sharded(plan) or S.size == 0:
            return S
        from jax.sharding import NamedSharding, PartitionSpec as PS
        ndev = self.mesh.shape[self.mesh_axis]
        if plan.M % ndev != 0 or plan.M == 0:
            return S
        s = NamedSharding(self.mesh, PS(None, None, self.mesh_axis))
        if isinstance(S, jax.core.Tracer):
            return jax.lax.with_sharding_constraint(S, s)
        return jax.device_put(S, s)

    def _device_constants(self):
        """Plan index arrays as device buffers, passed (not embedded) into
        the compiled programs. Batch-indexed arrays are sharded over the
        mesh; link arrays stay replicated (they are tiny — the Schur
        stacks they index carry the real data movement)."""
        c = []
        for rnd, p in enumerate(self.plans):
            if rnd in self._skip_consts:
                # factor-only resume: this round's factors come straight
                # off disk — it is never assembled, extend-added, or
                # solved through, so none of its plan arrays are needed
                c.append(None)
                continue
            c.append(dict(
                a_col=self._put(p.a_col, p.B),
                a_csrc=self._put(p.a_csrc, p.B),
                a_pos=self._put(p.a_pos, p.B), a_src=self._put(p.a_src, p.B),
                # static: any real spill entries? (sentinels are >= N*N)
                spill=bool((p.a_pos < p.N * p.N).any()),
                p_arr=self._put(p.p_arr, p.B),
                own=self._put(p.cells_own, p.B),
                bor=self._put(p.cells_bor, p.B),
                groups=[(g.src_round, self._put(g.src_slots, None),
                         self._put(g.dst_slots, None), self._put(g.inv, None))
                        for g in p.child_groups]))
        return c

    # -- factorization: per-chunk bucketed kernels -------------------------
    # (compiled shapes are bucketed, so kernels are reused across chunks
    # of one problem AND across problem sizes; the solve path stays fused
    # into one program because per-solve dispatch latency matters)

    def _flatten_consts(self):
        """The solve program's constants: per-round (own, bor) cell index
        maps, passed as arguments rather than baked in."""
        return tuple((cc["own"], cc["bor"]) for cc in self._consts)

    def _plan_pm(self, plan) -> np.ndarray:
        """True (pivot, border) sizes per batch entry of a round — the
        trim map for unpadded factor checkpoints (checkpoint.py v3 round
        format). Batch entries beyond the real fronts (mesh batch-multiple
        padding) are (0, 0): nothing of theirs is stored."""
        pm = np.zeros((plan.B, 2), dtype=np.int64)
        for b, nid in enumerate(plan.node_ids):
            f = self.sym.fronts[nid]
            pm[b] = (f.p, f.n - f.p)
        return pm

    def _ckpt_for(self, matrix: SparseMatrix, nz: np.ndarray | None = None):
        """Round checkpointer keyed to this matrix's VALUES (in factor
        precision) + plan shape + factor-layout version + pack_bs — the
        key under which two engines (e.g. a single-chip factor-only pass
        and a multi-device solve pass) agree they are resuming the same
        factorization."""
        if self._ckpt_dir is None:
            return None
        if nz is None:
            nz = np.zeros(len(matrix.nzval) + 1, dtype=self.prec)
            nz[:-1] = matrix.nzval
        import hashlib
        from .checkpoint import FactorRoundCheckpointer
        h = hashlib.sha1(nz.tobytes())
        h.update(np.int64([self.flat_len, len(self.plans)]).tobytes())
        # factor LAYOUT version: bump when the stored-factor semantics
        # change (v2 = _pack_diag_inv block-substitution layout) so a
        # resume can never mix checkpoints across layouts; a
        # non-default pack_bs changes the packed-K layout and keys in
        # (128 stays bare "v2" so long mesh runs span this change)
        h.update(b"factor-layout-v2")
        if self._pack_bs != PANEL:
            h.update(f"pack_bs={self._pack_bs}".encode())
        return FactorRoundCheckpointer(self._ckpt_dir, h.hexdigest())

    def _scan_done(self, ckpt) -> set[int]:
        """Resumable rounds: shape- and value-valid checkpoints, minus (to
        a fixpoint) any round whose Schur stack a not-yet-checkpointed
        consumer needs but whose S file is gone — dropping a round can
        orphan its own sources' Schur needs in turn."""
        done = ckpt.scan(self.plans)
        if not done:
            return done
        consumers: list[list[int]] = [[] for _ in self.plans]
        for rnd, plan in enumerate(self.plans):
            for g in plan.child_groups:
                consumers[g.src_round].append(rnd)
        changed = True
        while changed:
            changed = False
            for rnd in list(done):
                need = any(c not in done for c in consumers[rnd])
                if need and self.plans[rnd].M > 0 \
                        and not ckpt.has_schur(rnd):
                    done.discard(rnd)
                    changed = True
        return done

    def _factorize(self, matrix: SparseMatrix) -> None:
        # drop any previous factors FIRST: holding the old set while the
        # new one builds doubles peak memory on the refactor path. Nothing
        # holds the factors in a reference cycle (tests/test_mf_jax.py
        # pins this), so dropping the reference frees them at once
        self.factors = None
        self._factor_dispatch(matrix)

    def _factor_body(self, nzval_ext, consts):
        """The whole numeric factorization: per-chunk assembly, extend-add,
        partial factor, in dependency order, one dispatch per kernel.

        With a FactorRoundCheckpointer attached (long simulated-mesh or
        production runs), every completed round is persisted and valid
        checkpointed rounds are loaded instead of recomputed — the
        factorization resumes across process restarts."""
        factors = []
        schur: list = [None] * len(self.plans)
        uses = [0] * len(self.plans)
        consumers: list[list[int]] = [[] for _ in self.plans]
        for rnd, plan in enumerate(self.plans):
            for g in plan.child_groups:
                uses[g.src_round] += 1
                consumers[g.src_round].append(rnd)
        ckpt = self._ckpt
        done: set[int] = set()
        repair: set[int] = set()
        if ckpt is not None:
            done = self._scan_done(ckpt)
            # Schur repair: rounds whose factor checkpoint is valid but
            # whose Schur stack (needed by a not-yet-computed consumer)
            # is gone — recompute them to regenerate the Schur flow, but
            # keep their on-disk factors (skip save_round: re-streaming
            # tens of GB of already-banked factors through the host link
            # is the wrong trade; the recomputed factors match to fp32
            # rounding and the refinement contract absorbs that)
            repair = ckpt.scan(self.plans) - done
            if repair:
                dbg(1, f"factor checkpoint: {len(repair)} rounds have "
                       f"valid factors but missing Schur stacks — "
                       f"recomputing them for their Schur only")
        for rnd, plan in enumerate(self.plans):
            if rnd in done:
                need_s = (plan.M > 0
                          and any(c not in done for c in consumers[rnd]))
                loaded = ckpt.load_round(rnd, plan, self, need_schur=need_s,
                                         factors=not self._offload)
                if loaded is not None:
                    K, U12, L21, KD, perm, S = loaded
                    for g in plan.child_groups:
                        uses[g.src_round] -= 1
                        if uses[g.src_round] == 0:
                            schur[g.src_round] = None
                            ckpt.drop_schur(g.src_round)
                    factors.append((K, U12, L21, perm, KD))
                    schur[rnd] = S
                    continue
                done.discard(rnd)   # checkpoint vanished mid-run: recompute
            cc = consts[rnd]
            if cc is None:
                raise RuntimeError(
                    f"round {rnd}: factor checkpoint vanished after the "
                    f"factor-only resume scan (concurrent writer on "
                    f"{self._ckpt_dir}?) — its plan constants were skipped "
                    f"and it cannot be recomputed in this process")
            F = _assemble(nzval_ext, cc["a_col"], cc["a_csrc"],
                          cc["a_pos"], cc["a_src"], cc["p_arr"],
                          N=plan.N, P=plan.P, spill=cc["spill"])
            drops: list[int] = []
            for gi, g in enumerate(plan.child_groups):
                src_rnd = g.src_round      # static (plan), never traced
                _, ss, ds, inv = cc["groups"][gi]
                F = _extend_add(F, schur[src_rnd], ss, ds, inv)
                uses[src_rnd] -= 1
                if uses[src_rnd] == 0:
                    schur[src_rnd] = None   # free device memory eagerly...
                    drops.append(src_rnd)   # ...but delete FILES only after
                    # this round's own checkpoint is durable (below): a
                    # death between consume and save must leave a
                    # resumable on-disk prefix (the gx1 round-144
                    # incident: sources' S files were deleted during the
                    # extend-add, the process died before save_round, and
                    # the resume fixpoint cascaded 124 rounds back)
            K, U12, L21, S, perm = _partial_factor(
                F, P=plan.P, p_arr=cc["p_arr"], tau=self._tau,
                allow_native_lu=self.mesh is None, pack_bs=self._pack_bs)
            K, U12, L21, KD = self._shard_factors(plan, K, U12, L21)
            schur[rnd] = self._shard_schur(plan, S)
            if ckpt is not None and rnd in repair:
                # factors already banked on disk; persist only the
                # regenerated Schur (when a pending consumer needs it) so
                # the on-disk state stays resumable at every completed
                # round. The save doubles as the per-round sync point.
                if uses[rnd] > 0 and plan.M > 0 and S.size:
                    ckpt.save_schur(rnd, S)
                else:
                    jax.block_until_ready((S, K))
                for src in drops:
                    ckpt.drop_schur(src)
            elif ckpt is not None:
                ckpt.save_round(rnd, plan, K, U12, L21, perm,
                                S if uses[rnd] > 0 else None,
                                pm=self._plan_pm(plan))
                for src in drops:
                    ckpt.drop_schur(src)
            if ckpt is not None and not self._sync_rounds:
                # checkpointed single-device runs: the save above already
                # synchronized, so this timing is real per-round progress
                import time
                now = time.perf_counter()
                dbg(1, f"factor round {rnd + 1}/{len(self.plans)} "
                       f"B={plan.B} P={plan.P} N={plan.N} "
                       f"({now - self._round_t0:.1f}s)"
                       + (" [repair]" if rnd in repair else ""))
                self._round_t0 = now
            if self._offload:
                # out-of-core: the persisted factors stream back after
                # the last round (save_round's host fetch already forced
                # the computation); only Schur stacks stay live
                factors.append((None, None, None, None, None))
                K = U12 = L21 = KD = perm = None
            else:
                factors.append((K, U12, L21, perm, KD))
            if self._sync_rounds:
                # simulated (CPU) meshes only: with all virtual devices
                # time-sharing one host pool, letting many chunk programs
                # run concurrently can exhaust the pool with executions
                # blocked inside collectives whose remaining participants
                # are queued BEHIND them — a rendezvous deadlock XLA:CPU
                # kills after its timeout. One program in flight at a
                # time cannot starve itself. Device meshes never take
                # this branch.
                jax.block_until_ready((K, U12, L21, perm, schur[rnd]))
                import time
                now = time.perf_counter()
                dbg(1, f"factor round {rnd + 1}/{len(self.plans)} "
                       f"B={plan.B} P={plan.P} N={plan.N} "
                       f"({now - self._round_t0:.1f}s)")
                self._round_t0 = now
            if self._stop_after is not None and rnd >= self._stop_after:
                dbg(1, f"factor stop-after: handing off at round {rnd} "
                       f"({len(self.plans) - 1 - rnd} rounds remain)")
                return tuple(factors)
        if ckpt is not None:
            # every round is now checkpointed (saved this run, pre-existing,
            # or repaired-in-place): no future resume needs a Schur stack,
            # so clear any remaining S files (repair rounds deliberately
            # leave their sources' files in place during the run)
            for rnd, plan in enumerate(self.plans):
                if plan.M > 0:
                    ckpt.drop_schur(rnd)
        if self._offload and ckpt is not None and not self._factor_only:
            # stream the persisted factors back now that the factor
            # phase's transients and Schur stacks are gone: resident
            # memory goes straight to its solve-time steady state
            dbg(1, "factor offload: streaming factors back from "
                   f"{ckpt.dir}")
            for rnd, plan in enumerate(self.plans):
                if factors[rnd][0] is not None:
                    continue
                K, U12, L21, KD, perm, _ = ckpt.load_round(
                    rnd, plan, self, need_schur=False)
                factors[rnd] = (K, U12, L21, perm, KD)
        return tuple(factors)

    def _factor_dispatch(self, matrix: SparseMatrix) -> None:
        # sentinel zero at the end: padded a_src entries contribute nothing
        nz = np.zeros(len(matrix.nzval) + 1, dtype=self.prec)
        nz[:-1] = matrix.nzval
        # GESP static-pivot threshold (see _pivoted_panel): sqrt(eps) of
        # the factor precision times the (equilibrated) matrix magnitude —
        # sqrt equalizes the two error sources it trades (1/pivot growth
        # ~ 1/tau vs factorization perturbation ~ tau). Passed as a traced
        # scalar, so kernels cache across Newton iterations whose amax
        # drifts.
        eps = float(np.finfo(self.prec).eps)
        amax = float(np.max(np.abs(nz))) if len(matrix.nzval) else 1.0
        self._tau = float(np.float32(np.sqrt(eps) * amax))
        self._ckpt = self._ckpt_for(matrix, nz)
        nzval_ext = self._put(nz, None)
        # triangular solves lower to blocked matmuls that follow the
        # default matmul precision; reduced-precision passes would wreck a
        # direct solver. Scoped here (tracing happens inside) rather than
        # flipped process-globally — the GEMM call sites also pass HIGHEST
        # explicitly.
        import time
        self._round_t0 = time.perf_counter()
        with timed("factor dispatch"), jax.default_matmul_precision("highest"):
            self.factors = self._factor_body(nzval_ext, self._consts)
            jax.block_until_ready(self.factors)
        if self.mesh is not None and self.factors is not None:
            dbg(1, f"mesh: {self.sharded_rounds()} of {len(self.plans)} "
                   f"factor rounds sharded over "
                   f"{self.mesh.shape[self.mesh_axis]} devices")
        if self._factor_only:
            # the complete factor set lives on disk (checkpoint dir), not
            # in device memory; this engine cannot solve — resume from the
            # same checkpoint directory with a normal engine to solve
            dbg(1, "factor-only: factors persisted to "
                   f"{self._ckpt_dir}; engine holds none")
            self.factors = None

    def sharded_rounds(self) -> int:
        """Factor rounds whose stored arrays are split over the mesh."""
        return sum(1 for f in self.factors
                   if f[0] is not None
                   and not (f[0].sharding.is_fully_replicated
                            and f[1].sharding.is_fully_replicated))

    def refactor(self, matrix: SparseMatrix) -> None:
        """New numeric values, same pattern (Newton-iteration reuse)."""
        self._factorize(matrix)

    # -- solve as one program ----------------------------------------------

    def _hi_round(self, plan) -> bool:
        """Tree-top rounds (big eliminated blocks, where element growth
        concentrates) apply their substitution in float64: the factor
        bits stay float32, but the sequential block chain stops
        ACCUMULATING eps32 error, so refinement reaches the contract in
        fewer cycles at depth. NK_SOLVE_F64_MINP overrides the threshold
        (0 disables); requires x64 and float32 factors to mean anything."""
        minp = int(_os.environ.get("NK_SOLVE_F64_MINP", "4096"))
        return (minp > 0 and plan.P >= minp and self.prec == jnp.float32
                and jax.config.jax_enable_x64)

    def _solve_statics(self) -> dict:
        """The static arguments of _solve_rounds for this engine."""
        return dict(bs=self._pack_bs,
                    hi=tuple(self._hi_round(p) for p in self.plans))

    def _solve_program(self, W, factors, flat_consts):
        return _solve_rounds(W, factors, flat_consts, **self._solve_statics())

    def solve(self, b: np.ndarray) -> np.ndarray:
        if self.factors is None:
            raise RuntimeError("no numeric factors: load a factor "
                               "checkpoint or call refactor() first")
        B = np.asarray(b, dtype=np.float64)
        single = B.ndim == 1
        if single:
            B = B[:, None]
        nrhs = B.shape[1]
        # stage the RHS in factorization precision directly — a transient
        # float64 copy of (flat_len+1, nrhs) doubled peak memory exactly at
        # the point the factors are resident
        Wh = np.zeros((self.flat_len + 1, nrhs), dtype=self.prec)
        Wh[:self.flat_len] = B
        W = self._put_rhs(Wh)       # rhs-axis sharded if the mesh has one
        with jax.default_matmul_precision("highest"):
            W = _solve_rounds_jit(W, self.factors, self._flatten_consts(),
                                  **self._solve_statics())
        # slice on host AFTER the transfer: a device-side W[:flat_len]
        # would compile a throwaway slice program
        X = np.asarray(W, dtype=np.float64)[:self.flat_len]
        return X[:, 0] if single else X
