"""Plan-level memory accounting (host side, exact to the padded shapes).

The reference's distributed mode exists because the factors outgrow one
node's memory (src/solve_ABdist.c:106-244 block-row-distributes the
matrix; SuperLU_DIST distributes L/U over the process grid). The
rebuild's equivalent question — "how many devices does this problem need?"
— is answerable *before* factorization, because the round plans fix every
padded shape. This module walks a plan and reports:

  * resident factor bytes per round (K (B,P,P) + U12 (B,P,M) +
    L21 (B,M,P) + perm, plus the replicated KD diagonal stack on
    masked row-sharded rounds),
  * the Schur-complement live set over the round schedule (a round's
    (B,M,M) stack stays allocated until its last consuming round), and
  * the per-round transient peak: the full (B,N,N) front stack with the
    bounded extend-add temporaries, and the partial-factor program's
    input front, outputs and XLA temporaries (pf_temp_bytes),

each split replicated-vs-sharded for an n_devices mesh (rounds whose
batch divides the mesh shard over it; tree-top rounds stay replicated —
mirroring JaxMultifrontal._put).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MemoryPlan:
    n_devices: int
    bytes_per_elem: int
    factor_bytes_total: int       # all rounds' FP+L21+perm
    factor_bytes_per_device: int  # with sharded rounds divided by n_devices
    schur_peak_bytes: int         # max live Schur set (total, un-sharded)
    schur_peak_per_device: int
    transient_peak_bytes: int     # largest single-round working set (total)
    transient_peak_per_device: int
    rounds: list[dict]            # per-round breakdown

    @property
    def peak_per_device(self) -> int:
        """True high-water mark over the round schedule: each round's
        factors-resident-so-far + full front stack + index/extend-add
        transients + ALL live Schur stacks (pre-free, including the
        round's own output) — computed once per round in plan_memory
        (no double count of surviving stacks)."""
        return max((r["highwater_dev"] for r in self.rounds), default=0)

    def summary(self) -> str:
        gb = 1 / 2 ** 30
        return (f"factors {self.factor_bytes_total * gb:.2f} GB total / "
                f"{self.factor_bytes_per_device * gb:.2f} GB/device; "
                f"peak {self.peak_per_device * gb:.2f} GB/device "
                f"on {self.n_devices} device(s)")


def pf_temp_bytes(B: int, P: int, N: int, bytes_per_elem: int,
                  native_lu: bool, panel: int = 128) -> int:
    """XLA temporaries of one _partial_factor program: an envelope fitted
    to the compiled memory analysis, not a derivation.

    The panel loop is unrolled over ceil(P/panel) panels, and on the GPU
    XLA keeps about one front-sized buffer per panel: every gx3deep round
    on an H100 compiled to temporaries of 3.09-9.96x its (B,N,N) front
    stack, each within max(3.5, 1 + panels) fronts (PERF.md,
    scripts/factor_memory.py). Native-LU rounds (no panel loop) measured
    at most 2.0x there; on the CPU every round stays within 3.5x."""
    front = B * N * N * bytes_per_elem
    panels = 0 if native_lu else -(-P // panel)
    return max(7 * front // 2, (1 + panels) * front)


def plan_memory(plans, n_devices: int = 1, bytes_per_elem: int = 4,
                row_shard_min: int = 1024) -> MemoryPlan:
    """Exact padded-shape memory walk of a build_plan() output.

    Mirrors JaxMultifrontal's placement rules: batch-sharded rounds
    (B divides the mesh) divide everything by n_devices; small-batch
    big-front rounds (N >= row_shard_min, N divisible) divide their
    RESIDENT factor arrays by n_devices (front-axis sharding,
    _shard_factors) while their transients stay replicated.

    Each round has two phases. During assembly and extend-add the source
    Schur stacks are live beside the front stack. During the partial
    factor the sources consumed by this round are gone, and the program
    holds its input front, its outputs (this round's factors and Schur
    stack) and its temporaries (pf_temp_bytes)."""
    e = bytes_per_elem

    def shard(nbytes: int, B: int) -> int:
        if n_devices > 1 and B % n_devices == 0:
            return nbytes // n_devices
        return nbytes

    def shard_dim(nbytes: int, B: int, dim: int, qualifies: bool) -> int:
        """Resident-factor sharding: batch if it divides, else the given
        front axis when the round qualifies for row sharding."""
        if n_devices <= 1:
            return nbytes
        if B % n_devices == 0:
            return nbytes // n_devices
        if qualifies and dim % n_devices == 0 and dim > 0:
            return nbytes // n_devices
        return nbytes

    # last consumer of each round's Schur stack
    last_use = {}
    for rnd, plan in enumerate(plans):
        for g in plan.child_groups:
            last_use[g.src_round] = rnd

    rounds = []
    fac_tot = 0
    fac_dev = 0
    live: dict[int, tuple[int, int]] = {}   # rnd -> (bytes, dev_bytes)
    schur_peak = schur_peak_dev = 0
    trans_peak = trans_peak_dev = 0
    PANEL = 128   # mirrors mf_jax.PANEL (diagonal-block size)
    for rnd, plan in enumerate(plans):
        B, P, N, M = plan.B, plan.P, plan.N, plan.M
        k_b = B * P * P * e
        u12 = B * P * M * e
        l21 = B * M * P * e
        perm = B * P * 4
        q = N >= row_shard_min and N % max(n_devices, 1) == 0
        # masked row-sharded rounds additionally hold the replicated
        # PANEL-diagonal stack KD (B, P/bs, bs, bs) — see _shard_factors
        bs = min(PANEL, P)
        kd = 0
        if (q and n_devices > 1 and B % n_devices != 0
                and P % n_devices == 0 and bs and P % bs == 0):
            kd = B * P * bs * e
        f_bytes = k_b + u12 + l21 + perm + kd
        fac_tot += f_bytes
        qk = q and bs and P % bs == 0   # engine shards K only with a KD
        f_dev = (shard_dim(k_b, B, P, qk) + shard_dim(u12, B, M, q)
                 + shard_dim(l21, B, M, q) + shard(perm, B) + kd)
        fac_dev += f_dev
        # assembly / extend-add phase: the full (B,N,N) front stack, the
        # assembly index arrays, and the bounded extend-add temporaries
        # (~1 GB, see _extend_add's chunking)
        a_idx = (plan.a_pos.size * plan.a_pos.itemsize
                 + plan.a_src.size * plan.a_src.itemsize
                 + plan.a_col.size * plan.a_col.itemsize
                 + plan.a_csrc.size * plan.a_csrc.itemsize)
        # extend-add temporaries: 3 arrays of (Lc, N, M_src+1), Lc chosen
        # so each stays under ~0.5 GB (_extend_add's chunking) — but never
        # more than the actual link total
        ea = 0
        for g in plan.child_groups:
            msrc = plans[g.src_round].M + 1
            ea = max(ea, min(int(5e8), len(g.src_slots) * N * msrc * e) * 3)
        front = B * N * N * e
        front_dev = shard(front, B)
        asm = front + a_idx + ea
        asm_dev = front_dev + a_idx + ea
        s_before = sum(v[0] for v in live.values())
        s_before_dev = sum(v[1] for v in live.values())
        # free the stacks whose last consumer is this round
        for src, lr in list(last_use.items()):
            if lr == rnd:
                live.pop(src, None)
                del last_use[src]
        s_kept = sum(v[0] for v in live.values())
        s_kept_dev = sum(v[1] for v in live.values())
        # partial-factor phase: input front + temporaries + outputs (this
        # round's factors and its Schur stack; row-sharded rounds shard
        # the stack on the trailing axis, _shard_schur)
        s_bytes = B * M * M * e
        s_dev = shard_dim(s_bytes, B, M, q)
        temp = pf_temp_bytes(B, P, N, e, native_lu=B <= 2 and n_devices == 1,
                             panel=PANEL)
        pf = front + temp
        pf_dev = front_dev + shard(temp, B)
        trans = max(asm, pf)
        trans_dev = max(asm_dev, pf_dev)
        fac_prev, fac_prev_dev = fac_tot - f_bytes, fac_dev - f_dev
        hw = fac_prev + max(s_before + asm, s_kept + pf + f_bytes + s_bytes)
        hw_dev = fac_prev_dev + max(s_before_dev + asm_dev,
                                    s_kept_dev + pf_dev + f_dev + s_dev)
        live[rnd] = (s_bytes, s_dev)
        s_live = s_kept + s_bytes
        s_live_dev = s_kept_dev + s_dev
        schur_peak = max(schur_peak, s_live)
        schur_peak_dev = max(schur_peak_dev, s_live_dev)
        trans_peak = max(trans_peak, trans)
        trans_peak_dev = max(trans_peak_dev, trans_dev)
        rounds.append(dict(round=rnd, B=B, P=P, N=N, factor=f_bytes,
                           factor_dev=f_dev,
                           schur_live=s_live, schur_live_dev=s_live_dev,
                           transient=trans, transient_dev=trans_dev,
                           highwater=hw, highwater_dev=hw_dev))
    return MemoryPlan(n_devices=n_devices, bytes_per_elem=e,
                      factor_bytes_total=fac_tot,
                      factor_bytes_per_device=fac_dev,
                      schur_peak_bytes=schur_peak,
                      schur_peak_per_device=schur_peak_dev,
                      transient_peak_bytes=trans_peak,
                      transient_peak_per_device=trans_peak_dev,
                      rounds=rounds)
