"""Time-axis halo exchange inside shard_map (SURVEY.md section 5,
"long-context / sequence parallelism" build plan).

Overlap-save FIR filtering of a time-sharded stream: each shard needs the
last (ntaps-1) samples of its left neighbor -- one ppermute over the
``time`` mesh axis. The leftmost shard receives the block-level
carried tail instead, preserving exact streaming semantics across both
device boundaries and block boundaries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def left_halo(x_local, halo: int, axis_name: str, leftmost_fill):
    """Fetch the last ``halo`` samples of the left neighbor's local block.

    x_local: (..., N_local) this shard's samples; leftmost_fill: (..., halo)
    values for the leftmost shard (carried tail, or zeros). Returns
    (..., halo) array. Single collective: ppermute right by one; a
    single-shard axis degenerates to the fill (pure block streaming).
    """
    n_shards = lax.axis_size(axis_name)
    if halo <= 0:
        return x_local[..., :0]
    if n_shards == 1:
        return leftmost_fill
    idx = lax.axis_index(axis_name)
    tail = x_local[..., -halo:]
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    from_left = lax.ppermute(tail, axis_name, perm)
    return jnp.where(idx == 0, leftmost_fill, from_left)


def left_halo_rows(x_local, halo: int, axis_name: str, leftmost_fill):
    """left_halo with time on axis 0 of an (N, ...) array — the layout of
    raw-int16 (N, 2) wire-sample blocks. Returns (halo, ...)."""
    n_shards = lax.axis_size(axis_name)
    if halo <= 0:
        return x_local[:0]
    if n_shards == 1:
        return leftmost_fill
    idx = lax.axis_index(axis_name)
    tail = x_local[-halo:]
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    from_left = lax.ppermute(tail, axis_name, perm)
    return jnp.where(idx == 0, leftmost_fill, from_left)


