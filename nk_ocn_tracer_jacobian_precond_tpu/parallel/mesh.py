"""Device mesh construction.

The reference organizes ranks as an nprow x npcol MPI process grid
(src/solve_ABglobal.c:307 superlu_gridinit). The JAX equivalent is a named
jax.sharding.Mesh: the solver shards front batches over the leading axis
("front") and the stencil SpMV shards the latitude axis over it ("band" —
the 1-D block-row domain decomposition, the analog of
solve_ABdist.c:139-144). The reference's 2-D grid expresses SuperLU's
internal block-cyclic layout; the multifrontal engine's equivalent second
dimension within a round is the front axis of the tree-top rounds
(mf_jax._shard_factors).

An optional second mesh axis "rhs" adds data parallelism over right-hand
sides: the solve's workspace W (flat_len+1, nrhs) shards its RHS axis
over it, so large tracer batches (the many-variable loop of
solve_ABglobal.c:370-388) split across device groups while the factors
replicate across the rhs axis — the device-mesh form of get_B_dist's
segment scatter (solve_ABdist.c:248-418) applied to the *batch*
dimension, which is the one that actually scales in this workflow.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis_names=("band",),
              rhs_devices: int = 1) -> Mesh:
    """Build a 1-D mesh over axis_names[0], or a 2-D (axis, "rhs") mesh
    when rhs_devices > 1 (n_devices must divide evenly)."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    if len(axis_names) != 1:
        raise ValueError("pass a single primary axis name (front/band); "
                         "rhs parallelism is requested via rhs_devices")
    if rhs_devices > 1:
        if n_devices % rhs_devices:
            raise ValueError(f"rhs_devices={rhs_devices} must divide "
                             f"n_devices={n_devices}")
        shape = (n_devices // rhs_devices, rhs_devices)
        return Mesh(np.array(devs[:n_devices]).reshape(shape),
                    (axis_names[0], "rhs"))
    return Mesh(np.array(devs[:n_devices]), axis_names)
