"""Self-contained demo problems for entry-point checks and dry runs."""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..drivers.gen_a import run_gen_a
from ..grid import gen_ind_maps, load_grid
from ..ops import AssemblyOptions, PerTracerOptions, assemble_jacobian
from ..ops.fieldsource import FileFieldSource
from ..testdata import make_circ_file


def make_demo_assembly(imt: int = 16, jmt: int = 12, km: int = 5,
                       seed: int = 0, **opt_kw):
    """Generate a synthetic circulation file and assemble its Jacobian."""
    d = tempfile.mkdtemp(prefix="nk_demo_")
    circ = os.path.join(d, "circ.nc")
    make_circ_file(circ, imt=imt, jmt=jmt, km=km, seed=seed)
    defaults = dict(hmix_type="const", vmix_type="file",
                    per_tracer=[PerTracerOptions(sink_type="const",
                                                 sink_rate=1.21e-4)])
    defaults.update(opt_kw)
    opts = AssemblyOptions(circ_fname=circ, **defaults)
    grid = load_grid(circ)
    maps = gen_ind_maps(np.asarray(grid.KMT), grid.km)
    asm = assemble_jacobian(grid, opts, FileFieldSource(circ), None, maps)
    return asm, maps
