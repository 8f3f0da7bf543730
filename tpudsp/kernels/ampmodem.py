"""AM modulation / demodulation (JAX/XLA).

Equivalent of liquid ``ampmodem`` (reference demod.hpp:221-307):
type in {dsb, usb, lsb}, carrier present or suppressed, modulation index
``mod``. The reference's carrier path is PLL-based coherent detection (the
author's comment at demod.hpp:87-91 endorses liquid's
ampmodem_demod_dsb_pll_carrier); we implement the same topology
block-parallel:

  carrier present:
      theta[n] <- PLL carrier scan on x (tpudsp/kernels/pll.py, bw 0.001)
      v = x * e^{-j theta}
      m_raw = Re(v)            (dsb)   |  sideband-split of v  (usb/lsb)
      y = (m_raw - DC) / mod   with DC tracked by a one-pole (rho = 0.9995),
                               run as a first-order associative scan --
                               this replaces liquid's FIR DC blocker whose
                               distortion the reference author worked around.
  carrier suppressed:
      dsb:      y = Re(x) / mod
      usb/lsb:  y = (I_d -/+ H{Q}) / mod   (Hilbert sideband split,
                                            tpudsp/kernels/hilbert.py c2r)

Matching modulators are provided for round-trip SNR testing (the executable
spec -- the reference repo has no tests, SURVEY.md section 4). Round-trip
identity: demod(mod(m)) == m (up to filter delay / PLL lock transient).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import scipy.signal as sig

from . import hilbert as hilb
from . import iir, pll

PLL_BW = 0.001       # carrier-recovery loop bandwidth (rad/sample units)
DC_RHO = 0.9995      # DC-tracking one-pole coefficient
HILB_M = 25          # sideband-split Hilbert semi-length (as SSBDemod's 25)


class AmpDemodState(NamedTuple):
    pll: pll.PllState
    dc: jnp.ndarray                # f32 scalar, tracked DC (carrier mode)
    c2r: hilb.C2RState             # sideband-split state (usb/lsb)


def ampdemod_init(m: int = HILB_M) -> AmpDemodState:
    return AmpDemodState(pll=pll.pll_init(), dc=jnp.float32(0.0), c2r=hilb.c2r_init(m))


def ampdemod_apply(state: AmpDemodState, x, h_hilb, mod_index, am_type: str, carrier: bool,
                   exact_pll: bool = True):
    """x: (N,) complex64 -> (new_state, y (N,) float32).
    am_type in {'dsb','usb','lsb'}; static Python args select the graph."""
    inv_mod = 1.0 / jnp.float32(mod_index)
    pst, dc, c2r = state
    if carrier:
        scan = pll.pll_carrier_scan if exact_pll else pll.pll_carrier_scan_chunked
        pst, thetas = scan(pst, x, PLL_BW)
        v = x * jnp.exp(-1j * thetas)
    else:
        v = x
    if am_type == "dsb":
        m_raw = v.real.astype(jnp.float32)
    else:
        c2r, (lower, upper) = hilb.c2r_apply(h_hilb, c2r, v)
        m_raw = upper if am_type == "usb" else lower
    if carrier:
        # rho = 0.9995 puts the pole near the unit circle: the plain f32
        # scan floors at ~86 dB (measured, FIDELITY.md). The
        # matmul-blocked scan (kernels/iir.py first_order_apply_blocked)
        # keeps the long-range carry in double-float (110.6 dB vs the f64
        # serial oracle, bar 100).
        dc, dc_track = iir.first_order_apply_blocked(
            1.0 - DC_RHO, DC_RHO, dc, m_raw)
        y = (m_raw - dc_track) * inv_mod
    else:
        y = m_raw * inv_mod
    return AmpDemodState(pst, dc, c2r), y.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Modulators (host/NumPy float64; test + signal-synthesis infrastructure)
# ---------------------------------------------------------------------------
def modulate(m: np.ndarray, mod_index: float, am_type: str = "dsb", carrier: bool = False,
             carrier_freq: float = 0.0) -> np.ndarray:
    """Synthesize a complex-baseband AM signal from real message m(t).

    dsb: env = mod*m (suppressed) or 1 + mod*m (carrier)
    usb/lsb: env = mod*(m +/- j H{m})/2 (+1 for carrier), analytic via FFT.
    Optional carrier_freq (cycles/sample) rotates the result.
    """
    m = np.asarray(m, dtype=np.float64)
    if am_type == "dsb":
        env = mod_index * m + 0j
    else:
        a = sig.hilbert(m)  # m + j H{m}
        if am_type == "lsb":
            a = np.conj(a)
        env = mod_index * a / 2.0
    if carrier:
        env = env + 1.0
    if carrier_freq:
        n = np.arange(len(m))
        env = env * np.exp(2j * np.pi * carrier_freq * n)
    return env.astype(np.complex128)
