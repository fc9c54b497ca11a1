"""Which accelerator JAX runs on, and where compiled programs are cached.

Every backend-dependent choice in the solver goes through ``platform()``:
the code knows two platforms, the host CPU (tests, simulated meshes) and an
NVIDIA GPU, and refuses anything else rather than guessing a code path.
"""

from __future__ import annotations

import os

PLATFORMS = ("cpu", "gpu")

# fixed in-checkout location of the persistent compile cache: the path is
# part of the cache key, so a directory that moves never hits
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def platform() -> str:
    """'cpu' or 'gpu', from jax.default_backend(); raises on any other."""
    import jax
    name = jax.default_backend()
    if name not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX backend {name!r}: this solver "
                           f"runs on {' or '.join(PLATFORMS)}")
    return name


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one directory.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is left
    alone; otherwise the cache lives at DEFAULT_CACHE_DIR. A directory the
    process already chose is kept. Returns the directory in use. Call it
    before the first compilation: JAX opens the cache once."""
    import jax
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return jax.config.jax_compilation_cache_dir
