"""Vectorized transcendental replacements for the hot demod paths.

XLA:CPU lowers jnp.arctan2 to per-element libm calls (measured 66 ms
for 2M points on a CPU — 28x the polynomial below). patan2 is a
minimax odd-polynomial approximation of atan on [0, 1] plus octant
reconstruction, pure jnp elementwise ops, so it vectorizes on the CPU
and fuses into the surrounding elementwise work on the GPU.

Max abs error ~2e-6 rad.  For the consumers that matters as follows:
an FM discriminator scales the phase error by 1/(2 pi kd), putting the
audio error floor near 114 dB — far below every FM fidelity pin in the
suite (30-91 dB, tests/test_demod.py, FIDELITY.md); in the carrier-PLL
error path the residual is absorbed by the loop (phase detector noise
~1e-6 rad against loop bandwidths of 1e-3).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Estrin-friendly odd-polynomial coefficients for atan(z), z in [-1, 1]
# (minimax degree 17; coefficients from the standard remez fit)
_C = (
    0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332, -0.01172120,
)


def _atan_unit(z):
    """atan(z) for |z| <= 1 via odd polynomial in z^2."""
    z2 = z * z
    acc = jnp.float32(_C[-1])
    for c in _C[-2::-1]:
        acc = acc * z2 + jnp.float32(c)
    return z * acc


def patan2(y, x):
    """atan2(y, x) -> (-pi, pi], elementwise.

    Octant reduction: atan(|t|) on the unit interval with t = min/max of
    |x|,|y|, then swap/sign fixes. Matches jnp.arctan2 to ~2e-6 rad away
    from the origin; returns 0 at (0, 0) like the XLA kernels' usage
    expects (arg of a zeroed squelch sample)."""
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    safe_hi = jnp.where(hi > 0, hi, 1.0)
    t = lo / safe_hi
    a = _atan_unit(t)
    a = jnp.where(ay > ax, jnp.float32(np.pi / 2) - a, a)   # swap fix
    a = jnp.where(x < 0, jnp.float32(np.pi) - a, a)         # left half-plane
    a = jnp.where(y < 0, -a, a)                             # lower half-plane
    return jnp.where(hi > 0, a, jnp.zeros_like(a))
