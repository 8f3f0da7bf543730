"""Mesh construction and sharding helpers (SURVEY.md section 2.3).

The reference has no parallelism of any kind (single thread, GIL held,
SURVEY.md section 2.3 evidence); in this framework the DSP analogs of the
ML parallelism strategies are first-class:

- ``channel`` axis: independent receiver chains (DP analog) -- zero
  communication, vmap + shard_map.
- ``time`` axis: one long IQ stream split across devices (SP/CP analog) --
  FIR/conv front ends exchange (ntaps-1)-sample halos with the left
  neighbor; contractive scan loops (AGC/PLL) re-derive entry state from a
  warmup-sized halo, which is exactly the on-chip chunked-scan scheme
  lifted to the mesh (tpudsp/kernels/agc.py, pll.py).

Transport is JAX collectives only (psum/ppermute/all_gather/all_to_all
under shard_map), which XLA hands to NCCL -- NVLink between the cards of
one host; no user transport code. Every card reaches every other at the
same rate, so mesh shapes follow the algorithm alone.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


def to_varying(x, axis_name: str = TIME_AXIS):
    """Mark a replicated value as device-varying over ``axis_name`` (pytree
    ok). shard_map's replication checking (check_vma) requires carries that
    START replicated (block-carried stream state) but BECOME per-shard
    (after mixing with halo data) to be cast explicitly."""
    from jax import lax

    def one(v):
        try:
            if axis_name in jax.typeof(v).vma:  # already varying: no-op
                return v
        except (AttributeError, TypeError):
            pass
        return lax.pcast(v, (axis_name,), to="varying")

    return jax.tree.map(one, x)


def make_mesh(n_channel: int = 1, n_time: int = 1, devices=None) -> Mesh:
    """Build a (channel, time) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    need = n_channel * n_time
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_channel, n_time)
    return Mesh(arr, (CHANNEL_AXIS, TIME_AXIS))


def bank_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a (channels, samples) IQ bank block."""
    return NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
