"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic is
exercised without accelerator hardware (``chip_smoke.py --four`` runs the
mesh paths on four GPUs).  Must run before any JAX backend is initialized.
"""

import os

# 8 fake CPU devices for mesh/sharding tests.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
