"""Test harness config: an 8-device virtual CPU mesh (SURVEY.md 4.4).

The tests run on the local CPU backend, with Pallas kernels in interpret
mode, unless JAX_PLATFORMS names the platforms: the GPU is exercised by
chip_smoke.py, bench.py and the tests marked ``chip``, run on the card
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/`` (they
skip elsewhere).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
