"""Polyphase arbitrary-rate resampler (JAX/XLA, planned shapes).

Equivalent of liquid ``resamp_{rrrf,crcf,cccf}`` (reference
resampler.hpp:12,47,81,136), re-architected for block execution per SURVEY.md Q4/Q8:
the reference discovers its output count sample-by-sample inside a C loop;
here the count is *planned* -- it is a deterministic function of
(block length N, rate, carried fractional phase tau), computed host-side
in float64, so device shapes are static and the kernel is a fully parallel
gather + bank-matmul.

Semantics (shared with tests/oracle/liquid_oracle.py ResampOracle):
  - X = [tail (2m samples), x (N samples)]; output k sits at continuous
    input position p_k = tau + k / rate, for all p_k < N.
  - y_k = dot(X[q_k : q_k + 2m], taps(frac_k)) with q_k = floor(p_k);
    taps linearly interpolate between polyphase rows floor(frac*npfb) and
    the next row (bank built by tpudsp/design/firdes.py resamp_bank).
  - new tau = tau + n_out / rate - N  (long-run exact rate).

The filter introduces a fixed m-sample group delay, like the reference's.
Rate changes keep tail+tau state (liquid resamp_set_rate keeps state,
reference resampler.hpp:96-99 / SURVEY.md Q5).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def resamp_init(ntaps: int, dtype=jnp.float32):
    """Zero tail of 2m (= ntaps) input samples."""
    return jnp.zeros((ntaps,), dtype=dtype)


def plan(tau: float, n_in: int, rate: float):
    """Host-side output plan (float64): number of outputs and their integer /
    fractional positions. Returns (n_out, q (i32 ndarray), frac (f32 ndarray),
    new_tau)."""
    rate = float(rate)
    tau = float(tau)
    n_out = int(np.floor((n_in - tau) * rate - 1e-9)) + 1 if tau < n_in else 0
    n_out = max(n_out, 0)
    k = np.arange(n_out, dtype=np.float64)
    p = tau + k / rate
    q = np.floor(p).astype(np.int32)
    frac = (p - q).astype(np.float32)
    new_tau = tau + n_out / rate - n_in
    return n_out, q, frac, new_tau


def resamp_apply(H, tail, x, q, frac):
    """Device kernel: gather windows + interpolated polyphase dot.

    H: (npfb+1, 2m) float32; tail: (2m,); x: (N,); q: (n_out,) int32
    window starts into X; frac: (n_out,) float32 in [0,1).
    Returns (new_tail, y (n_out,))."""
    ntaps = H.shape[1]
    npfb = H.shape[0] - 1
    X = jnp.concatenate([tail.astype(x.dtype), x])
    # windows: (n_out, 2m) gather
    win = X[q[:, None] + jnp.arange(ntaps, dtype=jnp.int32)[None, :]]
    fb = frac * npfb
    b = jnp.clip(fb.astype(jnp.int32), 0, npfb - 1)
    w = (fb - b.astype(jnp.float32))[:, None]
    taps = H[b] * (1.0 - w) + H[b + 1] * w  # (n_out, 2m)
    y = jnp.sum(win * taps.astype(win.dtype), axis=-1)
    return X[-ntaps:], y
