"""NCO/VCO mixing with uint32 modular phase (JAX/XLA).

Equivalent of liquid ``nco_crcf`` (reference nco.hpp:10-81). liquid keeps
the oscillator phase in a 32-bit integer accumulator; we match that exactly
(SURVEY.md section 2.2 row "nco_crcf"): phase and per-sample increment are
uint32, advanced with wrapping integer arithmetic, so a block mix of any
length is bit-stable (no float phase drift) and embarrassingly parallel:
theta[n] = phase + n * dtheta (mod 2^32) is a closed form, not a recurrence.

PLL semantics (liquid nco pll, used by the composite demods,
reference demod.hpp:26,103): bandwidth bw gives frequency gain alpha = bw
and phase gain beta = sqrt(bw); pll_step(dphi) does
freq += alpha*dphi; phase += beta*dphi. Sequential PLL loops live in
tpudsp/kernels/pll.py; this module is the parallel fixed-frequency path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

TWO_PI = 2.0 * np.pi
_U32_TO_RAD = np.float32(TWO_PI / 4294967296.0)


def rad_to_u32(theta: float) -> np.uint32:
    """Host-side: radians -> uint32 phase units (mod 2 pi)."""
    t = float(theta) % TWO_PI
    return np.uint32(int(round(t / TWO_PI * 4294967296.0)) & 0xFFFFFFFF)


def u32_to_rad(u) -> float:
    return float(u) * TWO_PI / 4294967296.0


def nco_angles(phase_u32, dtheta_u32, n: int):
    """Per-sample oscillator angles for an n-sample block.

    phase_u32, dtheta_u32: uint32 scalars (device). Returns (theta_f32 (n,),
    next_phase_u32). Exact modular arithmetic -- matches liquid's integer
    accumulator to 2^-32 of a cycle; the float32 conversion keeps angle
    error < 2^-24 * 2 pi (approx -120 dBc).
    """
    k = jnp.arange(n, dtype=jnp.uint32)
    th_u = phase_u32 + k * dtheta_u32  # uint32 wrap-around is exact mod 2^32
    theta = th_u.astype(jnp.float32) * _U32_TO_RAD
    next_phase = phase_u32 + jnp.uint32(n) * dtheta_u32
    return theta, next_phase


def mix_up(phase_u32, dtheta_u32, x):
    """y[n] = x[n] * e^{+j theta[n]} (liquid nco_crcf_mix_block_up,
    reference nco.hpp:66-73). Returns (next_phase, y)."""
    theta, nxt = nco_angles(phase_u32, dtheta_u32, x.shape[0])
    osc = jnp.exp(1j * theta).astype(jnp.complex64)
    return nxt, (x * osc).astype(jnp.complex64)


def mix_down(phase_u32, dtheta_u32, x):
    """y[n] = x[n] * e^{-j theta[n]} (liquid nco_crcf_mix_block_down,
    reference nco.hpp:75-81). Returns (next_phase, y)."""
    theta, nxt = nco_angles(phase_u32, dtheta_u32, x.shape[0])
    osc = jnp.exp(-1j * theta).astype(jnp.complex64)
    return nxt, (x * osc).astype(jnp.complex64)


def tone(phase_u32, dtheta_u32, n: int):
    """Pure oscillator block e^{j theta[n]} (complex64)."""
    theta, nxt = nco_angles(phase_u32, dtheta_u32, n)
    return nxt, jnp.exp(1j * theta).astype(jnp.complex64)
