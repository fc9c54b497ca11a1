"""Exactness of the extend-add and the assembly.

Both kernels move values without arithmetic on them (selection, and adds
of disjoint contributions), so on the CPU they must be BIT-EQUAL to a
straightforward numpy loop: the gather extend-add
(solver/mf_jax.py::_extend_add, duplicate destinations summed in link
order) and the ELL scatter plus spill scatter of _assemble.

Reference analog: the extend-add inside SuperLU_DIST's pdgstrf
(SuperLU_brief_tree.txt:12-14), a plain float64 scatter.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nk_ocn_tracer_jacobian_precond_tpu.solver import mf_jax
from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
    _assemble, _extend_add)


def _synthetic(B, N, M, Sb, L, seed=0):
    """Adversarial f64 data: full-width mantissas and magnitudes spanning
    ~1e12, duplicate destination slots."""
    rng = np.random.default_rng(seed)
    S_src = rng.standard_normal((Sb, M, M))
    S_src *= np.exp(rng.uniform(-14, 14, size=(Sb, M, M)))
    ss = rng.integers(0, Sb, size=L).astype(np.int32)
    ds = rng.integers(0, B, size=L).astype(np.int32)
    ds[1] = ds[0]                        # at least one duplicate dst slot
    iv = rng.integers(0, M + 1, size=(L, N)).astype(np.int32)  # M = pad
    return S_src, ss, ds, iv


def _oracle(B, N, S_src, ss, ds, iv):
    Spn = np.pad(S_src, ((0, 0), (0, 1), (0, 1)))
    ref = np.zeros((B, N, N))
    for l in range(len(ss)):
        ref[ds[l]] += Spn[ss[l]][iv[l]][:, iv[l]]
    return ref


def _run_ea(B, N, S_src, ss, ds, iv):
    return np.asarray(_extend_add(
        jnp.zeros((B, N, N), jnp.float64), jnp.asarray(S_src),
        jnp.asarray(ss), jnp.asarray(ds), jnp.asarray(iv)))


@pytest.mark.parametrize("B,N,M,Sb,L", [(6, 16, 24, 8, 13),
                                        (4, 8, 8, 4, 9),
                                        (2, 32, 20, 3, 7)])
def test_extend_add_bit_exact(B, N, M, Sb, L):
    S_src, ss, ds, iv = _synthetic(B, N, M, Sb, L)
    ref = _oracle(B, N, S_src, ss, ds, iv)
    np.testing.assert_array_equal(_run_ea(B, N, S_src, ss, ds, iv), ref)


@pytest.mark.parametrize("chunk", [1, 4])
def test_extend_add_link_chunks(chunk, monkeypatch):
    """Link chunking (bounded temporaries) splits duplicate destinations
    across chunks; the accumulated result must not change."""
    B, N, M, Sb, L = 3, 8, 12, 5, 11
    S_src, ss, ds, iv = _synthetic(B, N, M, Sb, L, seed=3)
    ref = _oracle(B, N, S_src, ss, ds, iv)
    monkeypatch.setattr(mf_jax, "_ea_chunk_len", lambda *a: chunk)
    _extend_add.clear_cache()        # chunk length is read at trace time
    try:
        out = _run_ea(B, N, S_src, ss, ds, iv)
    finally:
        monkeypatch.undo()
        _extend_add.clear_cache()
    np.testing.assert_array_equal(out, ref)


def _asm_case(seed, B=3, N=16, W=4, nnz=40, n_spill=5):
    """ELL rows plus spill entries at positions the ELL part leaves
    empty (build_plan's routing: each (row, col) arrives exactly once)."""
    rng = np.random.default_rng(seed)
    nzval_ext = np.zeros(nnz + 1)
    nzval_ext[:nnz] = rng.standard_normal(nnz) * np.exp(
        rng.uniform(-10, 10, nnz))
    a_col = np.zeros((B, N, W), np.int32)
    a_csrc = np.full((B, N, W), nnz, np.int32)
    used = np.zeros((B, N, N), bool)
    for b in range(B):
        for r in range(N):
            k = rng.integers(1, W + 1)
            cols = np.sort(rng.choice(N, size=k, replace=False))
            a_col[b, r, :k] = cols
            a_csrc[b, r, :k] = rng.integers(0, nnz, k)
            used[b, r, cols] = True
    E = n_spill + 2                      # trailing entries are padding
    a_pos = np.tile(N * N + np.arange(E, dtype=np.int32), (B, 1))
    a_src = np.full((B, E), nnz, np.int32)
    for b in range(B):
        free = np.flatnonzero(~used[b].reshape(-1))
        pos = rng.choice(free, size=n_spill, replace=False)
        a_pos[b, :n_spill] = pos
        a_src[b, :n_spill] = rng.integers(0, nnz, n_spill)
    p_arr = np.array([N, N - 3, 0][:B], np.int32)
    return nzval_ext, a_col, a_csrc, a_pos, a_src, p_arr


def _asm_oracle(nzval_ext, a_col, a_csrc, a_pos, a_src, p_arr, N, P):
    B = a_col.shape[0]
    F = np.zeros((B, N, N))
    for b in range(B):
        for r in range(N):
            for w in range(a_col.shape[2]):
                F[b, r, a_col[b, r, w]] += nzval_ext[a_csrc[b, r, w]]
        flat = F[b].reshape(-1)
        for pos, src in zip(a_pos[b], a_src[b]):
            if pos < N * N:
                flat[pos] += nzval_ext[src]
        for i in range(P):
            if i >= p_arr[b]:
                F[b, i, i] += 1.0
    return F


@pytest.mark.parametrize("P", [12, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_with_spills(seed, P):
    args = _asm_case(seed)
    N = args[1].shape[1]
    ref = _asm_oracle(*args, N=N, P=P)
    out = np.asarray(_assemble(*map(jnp.asarray, args), N=N, P=P,
                               spill=True))
    np.testing.assert_array_equal(out, ref)


def test_assemble_spill_flag_without_spills():
    """The engine compiles the spill scatter out (spill=False) when a
    round holds only padding spill entries; both programs must agree."""
    args = tuple(map(jnp.asarray, _asm_case(7, n_spill=0)))
    N = args[1].shape[1]
    F_on = _assemble(*args, N=N, P=N, spill=True)
    F_off = _assemble(*args, N=N, P=N, spill=False)
    np.testing.assert_array_equal(np.asarray(F_on), np.asarray(F_off))

