"""The float64 factor kernels against plain numpy references.

_pivoted_panel is the XLA column loop every multi-front round runs:
partial pivoting restricted to fully-summed rows, with the GESP static
pivot threshold tau (SuperLU_DIST's strategy). The tree-top rounds
(B <= 2, single device) run XLA's native LU with tau applied to U's
diagonal afterwards. _mm is the trailing-update GEMM.
"""

import numpy as np
import pytest
import scipy.linalg

import jax
import jax.numpy as jnp

from nk_ocn_tracer_jacobian_precond_tpu.solver.mf_jax import (
    _mm, _partial_factor, _pivoted_panel)


def _np_restricted_panel(Pan, off, p_arr, tau):
    """Textbook right-looking LU of a (B, R, T) panel: the pivot of
    column k is the largest |entry| among rows >= k that are fully summed
    (global row < p_arr[b]) — or row k itself; a pivot smaller than tau
    in magnitude becomes sign * tau."""
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


@pytest.mark.parametrize("B,R,T,off", [
    (4, 256, 128, 128),   # mid-panel: rows already eliminated above
    (3, 128, 128, 0),     # first panel
    (2, 512, 64, 0),      # narrow final panel
])
@pytest.mark.parametrize("tau", [0.0, 0.05])
def test_pivoted_panel_f64_matches_numpy(B, R, T, off, tau):
    rng = np.random.default_rng(0)
    Pan = rng.standard_normal((B, R, T))
    # mixed true eliminated counts: one front fully dummy (p=0, identity
    # diagonal pivots), one partially padded, one full
    p_arr = np.linspace(0, off + R, B).astype(np.int32)
    ref, piv_ref = _np_restricted_panel(Pan, off, p_arr, tau)
    out, piv = _pivoted_panel(jnp.asarray(Pan), off, jnp.asarray(p_arr),
                              tau)
    np.testing.assert_array_equal(np.asarray(piv), piv_ref)
    # XLA may contract a - l*u into one FMA where numpy rounds twice; the
    # per-step difference of one ulp is amplified by the panel's element
    # growth (max|entry| ~ 4e3 here), hence 1e-10 of the largest entry
    err = np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()
    assert err <= 1e-10, err


def _schur_ref(F, P, tau):
    """Schur complement from a LAPACK partial-pivoting LU of F11 with U's
    diagonal clamped to |u_kk| >= tau (the native-LU path's rule)."""
    lu, piv = scipy.linalg.lu_factor(F[:P, :P])
    d = np.diag(lu).copy()
    small = np.abs(d) < tau
    d[small] = np.where(d[small] < 0, -tau, tau)
    lu[np.diag_indices(P)] = d
    perm = np.arange(P)
    for k, s in enumerate(piv):
        perm[[k, s]] = perm[[s, k]]
    L = np.tril(lu, -1) + np.eye(P)
    U = np.triu(lu)
    U12 = scipy.linalg.solve_triangular(L, F[:P, P:][perm], lower=True,
                                        unit_diagonal=True)
    L21 = scipy.linalg.solve_triangular(U.T, F[P:, :P].T, lower=True).T
    return F[P:, P:] - L21 @ U12


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_small_batch_native_lu_vs_numpy(tau):
    """B <= 2 rounds on a single device take XLA's native LU; its Schur
    complement must match a numpy partial-pivoting LU with the same
    post-hoc tau clamp — and with tau = 0 it must equal the restricted
    panel loop's (a Schur complement does not depend on the pivots)."""
    rng = np.random.default_rng(1)
    B, P, N = 2, 128, 192
    F = rng.standard_normal((B, N, N))
    F[:, :P, :P] += 4 * np.eye(P) * (rng.random(P) < 0.5)
    p_arr = jnp.full((B,), P, jnp.int32)
    with jax.default_matmul_precision("highest"):
        K, U12, L21, S, perm = _partial_factor(
            jnp.asarray(F), P=P, p_arr=p_arr, tau=tau, allow_native_lu=True)
        S_loop = _partial_factor(jnp.asarray(F), P=P, p_arr=p_arr, tau=tau,
                                 allow_native_lu=False)[3]
    for b in range(B):
        ref = _schur_ref(F[b], P, tau)
        np.testing.assert_allclose(np.asarray(S[b]), ref, rtol=1e-9,
                                   atol=1e-9 * np.abs(ref).max())
    if tau == 0.0:
        np.testing.assert_allclose(np.asarray(S), np.asarray(S_loop),
                                   rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(S)).max())


@pytest.mark.parametrize("B,M,K,N", [(1, 64, 128, 96), (4, 33, 17, 250),
                                     (2, 256, 128, 256)])
def test_mm_f64_matches_numpy(B, M, K, N):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((B, M, K)) * np.exp(rng.uniform(-5, 5, (B, M, 1)))
    b = rng.standard_normal((B, K, N))
    ref = np.matmul(a, b)
    got = np.asarray(_mm(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.float64
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-14, err


def test_mm_f32_highest_matches_numpy():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 96, 200)).astype(np.float32)
    b = rng.standard_normal((3, 200, 64)).astype(np.float32)
    ref = np.matmul(a, b)
    got = np.asarray(_mm(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.float32
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-5, err
