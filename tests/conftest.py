"""Test configuration: force JAX onto a simulated 8-device CPU mesh.

The reference could only exercise its distributed path on a real MPI
cluster (SURVEY.md §4); here every multi-device code path is testable on a
single host via XLA's simulated devices. XLA_FLAGS must be set before
the CPU backend is first created; the config update pins the CPU even
where an accelerator is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402  (after XLA_FLAGS so the CPU backend sees it)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
