import os
import sys

# Run JAX-dependent tests on a virtual 8-device CPU mesh, even where an
# accelerator is present: the platform is pinned in jax's config after
# import, so it holds whatever JAX_PLATFORMS says. Tests that need the GPU
# carry the `gpu` marker and run as phases of chip_smoke.py.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
