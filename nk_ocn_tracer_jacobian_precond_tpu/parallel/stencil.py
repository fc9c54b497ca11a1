"""Matrix-free stencil SpMV operator — the device-native form of the Jacobian.

The assembled Jacobian's structured form (per-offset dense coefficient
fields, ops/assemble.py) applies to tracer fields directly as shifted
multiply-adds: no CSR gather/scatter, fully vectorized, and it shards over
a device mesh by latitude bands with a width-2 halo exchange
(jax.lax.ppermute) — the ICI-native replacement for the reference's
MPI block-row partition (src/solve_ABdist.c:139-144). Used for residual
computation in iterative refinement and as the operator for Krylov solves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.assemble import Assembly
from ..ops.offsets import target_wet, wet3d


def _sanitize(asm: Assembly):
    """Zero coefficients at invalid (row, target) pairs so the dense fields
    are safe to multiply everywhere (the CSR emission masks these; the
    stencil operator needs clean zeros instead)."""
    grid = asm.grid
    km = grid.km
    KMT = np.asarray(grid.KMT)
    wet = wet3d(KMT, km)
    offsets = []
    coefs = []
    for off, arr in asm.shared.items():
        if off == (0, 0, 0):
            continue
        valid = wet & target_wet(KMT, km, *off)
        offsets.append(off)
        coefs.append(np.where(valid, arr, 0.0))
    selfs = np.stack([np.where(wet, s, 0.0) for s in asm.self_full])
    kk = np.arange(km)[:, None, None]
    vmix = None
    if asm.vmix_dense is not None:
        valid = wet[None, :] & (np.arange(km)[:, None, None, None] < KMT[None, None])
        vmix = np.where(valid, asm.vmix_dense, 0.0)
    sink = []
    for t, sd in enumerate(asm.sink_dense):
        if sd is None:
            sink.append(None)
        else:
            valid = wet[None, :] & (np.arange(km)[:, None, None, None] <= kk[None])
            sink.append(np.where(valid, sd, 0.0))
    cross = {}
    for (t, t2), arr in asm.cross.items():
        cross[(t, t2)] = np.where(wet, arr, 0.0)
    return offsets, coefs, selfs, vmix, sink, cross


def _shift_x(x, dk, dj, di):
    """x (..., km, j, i) -> x at (k+dk, j+dj, i+di); i wraps, k/j zero-pad.
    Shifting in j assumes the needed rows are present (halos prepended /
    appended by the sharded caller)."""
    if dk:
        x = jnp.roll(x, -dk, axis=-3)
        if dk > 0:
            x = x.at[..., -dk:, :, :].set(0.0)
        else:
            x = x.at[..., :-dk, :, :].set(0.0)
    if dj:
        x = jnp.roll(x, -dj, axis=-2)
    if di:
        x = jnp.roll(x, -di, axis=-1)
    return x


@dataclass
class StencilOperator:
    offsets: list[tuple[int, int, int]]
    coefs: np.ndarray          # (n_off, km, jmt, imt), shared across tracers
    selfs: np.ndarray          # (nt, km, jmt, imt)
    vmix: np.ndarray | None    # (km2, km, jmt, imt)
    sink: list                 # per tracer: (km2, km, jmt, imt) or None
    cross: dict                # (t, t2) -> (km, jmt, imt)
    nt: int
    shape: tuple               # (km, jmt, imt)

    @classmethod
    def from_assembly(cls, asm: Assembly) -> "StencilOperator":
        offsets, coefs, selfs, vmix, sink, cross = _sanitize(asm)
        return cls(offsets=offsets,
                   coefs=np.stack(coefs) if coefs else
                   np.zeros((0,) + selfs.shape[1:]),
                   selfs=selfs, vmix=vmix, sink=sink, cross=cross,
                   nt=asm.nt,
                   shape=(asm.grid.km, asm.grid.jmt, asm.grid.imt))

    # -- single-device apply ----------------------------------------------

    def apply(self, x):
        """y = A x on tracer fields; x, y are (nt, km, jmt, imt) with zeros
        on land."""
        y = self.selfs * x
        for o, off in enumerate(self.offsets):
            y = y + self.coefs[o][None] * _shift_x(x, *off)
        if self.vmix is not None:
            y = y + jnp.einsum("bkji,tbji->tkji", self.vmix, x,
                               preferred_element_type=x.dtype)
        for t, sd in enumerate(self.sink):
            if sd is not None:
                y = y.at[t].add(jnp.einsum("bkji,bji->kji", sd, x[t],
                                           preferred_element_type=x.dtype))
        for (t, t2), arr in self.cross.items():
            y = y.at[t].add(arr * x[t2])
        return y

    # -- flat-vector interface (for refinement / Krylov) -------------------

    def matvec_factory(self, maps):
        """Return a jitted flat-vector matvec using the index maps."""
        scat_k = jnp.asarray(maps.ind_to_k)
        scat_j = jnp.asarray(maps.ind_to_j)
        scat_i = jnp.asarray(maps.ind_to_i)
        tsl = maps.tracer_state_len
        nt = self.nt
        km, jmt, imt = self.shape
        op = self._device_copy()

        @jax.jit
        def matvec(xflat):
            x = jnp.zeros((nt, km, jmt, imt), dtype=xflat.dtype)
            xs = xflat.reshape(nt, tsl)
            x = x.at[:, scat_k, scat_j, scat_i].set(xs)
            y = op.apply(x)
            return y[:, scat_k, scat_j, scat_i].reshape(nt * tsl)

        return matvec

    def _device_copy(self) -> "StencilOperator":
        conv = lambda a: None if a is None else jnp.asarray(a)
        return StencilOperator(
            offsets=self.offsets, coefs=conv(self.coefs),
            selfs=conv(self.selfs), vmix=conv(self.vmix),
            sink=[conv(s) for s in self.sink],
            cross={k: conv(v) for k, v in self.cross.items()},
            nt=self.nt, shape=self.shape)

    # -- mesh-sharded apply ------------------------------------------------

    def sharded_apply_factory(self, mesh: Mesh, axis: str = "band"):
        """Build a jitted y = A x over latitude-band-sharded fields.

        Fields are padded so jmt divides the band axis; halo exchange of
        width 2 (the widest stencil reach, upwind3's j±2) uses ppermute
        rings over ICI. Returns (apply_fn, sharding, pad_fields, unpad).
        """
        nband = mesh.shape[axis]
        km, jmt, imt = self.shape
        jmt_pad = (jmt + nband - 1) // nband * nband
        pad = jmt_pad - jmt

        def pad_j(a, j_axis):
            if pad == 0:
                return a
            widths = [(0, 0)] * a.ndim
            widths[j_axis] = (0, pad)
            return np.pad(np.asarray(a), widths)

        offsets = list(self.offsets)
        cross_keys = sorted(self.cross.keys())

        # flat parameter list: (kind, array, j_axis_index)
        entries = [("coefs", pad_j(self.coefs, 2), 2),
                   ("selfs", pad_j(self.selfs, 2), 2)]
        if self.vmix is not None:
            entries.append(("vmix", pad_j(self.vmix, 2), 2))
        for t, s in enumerate(self.sink):
            if s is not None:
                entries.append((("sink", t), pad_j(s, 2), 2))
        for key in cross_keys:
            entries.append((("cross",) + key, pad_j(self.cross[key], 1), 1))
        kinds = [e[0] for e in entries]

        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map

        xspec = P(None, None, axis, None)
        pspecs = tuple(
            P(*([None] * jax_ax + [axis, None]))
            for (_, arr, jax_ax) in entries)

        perm_fwd = [(s, (s + 1) % nband) for s in range(nband)]
        perm_bwd = [(s, (s - 1) % nband) for s in range(nband)]

        def local_apply(x_l, *params):
            p = dict(zip(kinds, params))
            # halo exchange: 2 rows from the south (j-1) and north (j+1)
            lo = jax.lax.ppermute(x_l[:, :, -2:, :], axis, perm_fwd)
            hi = jax.lax.ppermute(x_l[:, :, :2, :], axis, perm_bwd)
            xh = jnp.concatenate([lo, x_l, hi], axis=2)
            y = p["selfs"] * x_l
            coefs_l = p["coefs"]
            for o, off in enumerate(offsets):
                sh = _shift_x(xh, *off)[:, :, 2:-2, :]
                y = y + coefs_l[o][None] * sh
            if "vmix" in p:
                y = y + jnp.einsum("bkji,tbji->tkji", p["vmix"], x_l,
                                   preferred_element_type=x_l.dtype)
            for kind in kinds:
                if isinstance(kind, tuple) and kind[0] == "sink":
                    t = kind[1]
                    y = y.at[t].add(
                        jnp.einsum("bkji,bji->kji", p[kind], x_l[t],
                                   preferred_element_type=x_l.dtype))
                elif isinstance(kind, tuple) and kind[0] == "cross":
                    _, t, t2 = kind
                    y = y.at[t].add(p[kind] * x_l[t2])
            return y

        sharded = shard_map(local_apply, mesh=mesh,
                            in_specs=(xspec,) + pspecs,
                            out_specs=xspec)

        sharding = NamedSharding(mesh, xspec)
        dev_params = tuple(
            jax.device_put(arr, NamedSharding(mesh, spec))
            for (_, arr, _), spec in zip(entries, pspecs))

        @jax.jit
        def apply_fn(x):
            return sharded(x, *dev_params)

        def pad_field(x):
            return np.pad(np.asarray(x), [(0, 0), (0, 0), (0, pad), (0, 0)])

        def unpad_field(y):
            return np.asarray(y)[:, :, :jmt, :]

        return apply_fn, sharding, pad_field, unpad_field
