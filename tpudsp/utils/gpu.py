"""Run-time helpers for the GPU entry points (bench.py, chip_smoke.py):
the card line, the accelerator check and the compile-cache placement."""

from __future__ import annotations

import os
import subprocess

# <checkout>/.jax_cache: fixed, so a later run finds what an earlier one
# compiled (the path is part of the cache key); listed in .gitignore
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    other directory is set here; otherwise the cache lives in the
    checkout's .jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def require_gpu():
    """The first JAX device, which must be a GPU; raises otherwise."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this entry point measures the card only")
    return dev
