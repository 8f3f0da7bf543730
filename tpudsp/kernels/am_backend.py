"""Combined AM-chain back end: AGC -> carrier PLL -> DC tracker ->
de-emphasis as ONE per-sample recurrence.

The AM receiver's post-resampler stages (chains/am.py _back_end) are four
coupled recurrences over the same 48 kHz stream. Composing their chunked
kernels runs the warmup+chunk sample loop three times with HBM round
trips between stages; this module defines the combined single-pass
step -- used by the exact lax.scan reference here and by the fused Pallas
kernel (tpudsp/pallas/am_backend_scan.py) that keeps the loop state in
registers.

Per sample (x complex input at the pcm rate):
    y      = x * g                        (AGC gain)
    y2p    = (1-alpha) y2p + alpha |y|^2
    g     *= exp(-alpha/2 ln y2p)         (unless locked; clamped 1e6)
    FSM step on rssi = -20 log10 g;  out0 = 0 in ENABLED/SIGNALLO else y*scale
    v      = out0 * e^{-j theta}          (carrier PLL; identity if no carrier)
    err    = atan2(Im v, Re v)
    freq  += pll_alpha * err; theta += pll_beta * err + freq (wrapped)
    m_raw  = Re v
    dc     = rho dc + (1-rho) m_raw
    audio  = (m_raw - dc) / mod
    pcm    = b0 * audio + a * pcm_prev    (de-emphasis)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

# NOTE on atan2 choice: these per-sample steps run inside sequential
# scans over SMALL lane vectors (the chunk count), where one fused libm
# atan2 per step beat fastmath.patan2's longer elementwise op chain
# (measured on the CPU: the fused AM chain lost ~20% end to end with
# patan2 here). patan2 wins on the wide elementwise paths (freqdem,
# fm_base). The Pallas kernel's Triton route lowers libm atan2 too.

from . import agc as kagc
from .agc import AgcParams, AgcState, _fsm_step
from .ampmodem import DC_RHO, PLL_BW
from .pll import PllState


class AmBackendState(NamedTuple):
    agc: AgcState
    pll: PllState
    dc: jnp.ndarray      # f32
    deemph: jnp.ndarray  # f32


class AmBackendParams(NamedTuple):
    agc: AgcParams
    pll_alpha: jnp.ndarray
    pll_beta: jnp.ndarray
    use_pll: jnp.ndarray   # f32 1.0/0.0 (carrier present / suppressed)
    dc_rho: jnp.ndarray
    use_dc: jnp.ndarray    # f32 1.0/0.0 (DC tracking only with carrier)
    inv_mod: jnp.ndarray
    deemph_b0: jnp.ndarray
    deemph_a: jnp.ndarray


def make_params(agc_params: AgcParams, mod_index, deemph_b0, deemph_a,
                carrier: bool, pll_bw: float = PLL_BW,
                dc_rho: float = DC_RHO) -> AmBackendParams:
    return AmBackendParams(
        agc=agc_params,
        pll_alpha=jnp.float32(pll_bw),
        pll_beta=jnp.float32(np.sqrt(pll_bw)),
        use_pll=jnp.float32(1.0 if carrier else 0.0),
        dc_rho=jnp.float32(dc_rho),
        use_dc=jnp.float32(1.0 if carrier else 0.0),
        inv_mod=jnp.float32(1.0) / jnp.asarray(mod_index, jnp.float32),
        deemph_b0=jnp.asarray(deemph_b0, jnp.float32),
        deemph_a=jnp.asarray(deemph_a, jnp.float32),
    )


def init_state() -> AmBackendState:
    return AmBackendState(agc=kagc.agc_init(), pll=PllState(jnp.float32(0.0), jnp.float32(0.0)),
                          dc=jnp.float32(0.0), deemph=jnp.float32(0.0))


def sample_step(p: AmBackendParams, st: AmBackendState, xr, xi,
                atan2=jnp.arctan2):
    """One combined step on real/imag parts (works on scalars or lanes)."""
    g, y2p, mode, timer = st.agc
    theta, freq = st.pll
    yr = xr * g
    yi = xi * g
    y2 = yr * yr + yi * yi
    y2p = (1.0 - p.agc.alpha) * y2p + p.agc.alpha * y2
    g_new = jnp.minimum(g * jnp.exp(-0.5 * p.agc.alpha * jnp.log(y2p + 1e-30)), 1e6)
    g = jnp.where(p.agc.locked, g, g_new)
    rssi = -20.0 * jnp.log10(jnp.maximum(g, 1e-30))
    high = rssi > p.agc.threshold
    mode, timer = _fsm_step(mode, timer, high, p.agc.timeout, p.agc.squelch)
    zero = (mode == kagc.SQ_ENABLED) | (mode == kagc.SQ_SIGNALLO)
    outr = jnp.where(zero, 0.0, yr * p.agc.scale)
    outi = jnp.where(zero, 0.0, yi * p.agc.scale)

    c = jnp.cos(theta)
    s = jnp.sin(theta)
    vr = outr * c + outi * s          # Re(out * e^{-j theta})
    vi = outi * c - outr * s
    err = atan2(vi, vr) * p.use_pll
    freq = freq + p.pll_alpha * err
    theta_n = theta + p.pll_beta * err + freq
    theta = jnp.mod(theta_n + np.pi, 2.0 * np.pi) - np.pi

    dc = p.dc_rho * st.dc + (1.0 - p.dc_rho) * vr
    audio = (vr - dc * p.use_dc) * p.inv_mod
    pcm = p.deemph_b0 * audio + p.deemph_a * st.deemph

    new_st = AmBackendState(AgcState(g, y2p, mode, timer),
                            PllState(theta, freq), dc, pcm)
    return new_st, (pcm, mode)


def am_backend_exact(p: AmBackendParams, st: AmBackendState, x):
    """Exact sequential combined back end (lax.scan). x: (N,) complex64.
    Returns (state, (pcm, modes))."""

    def step(s, xn):
        return sample_step(p, s, xn.real.astype(jnp.float32),
                           xn.imag.astype(jnp.float32))

    return jax.lax.scan(step, st, x)


class FrontState(NamedTuple):
    agc: AgcState
    pll: PllState


def front_sample_step(p: AmBackendParams, st: FrontState, xr, xi,
                      atan2=jnp.arctan2):
    """The FEEDBACK part only (AGC + carrier PLL) -> per-sample vr = Re(v).

    The DC tracker and de-emphasis are linear filters of vr with no
    feedback into this loop -- and the DC tracker's time constant
    (1/(1-rho) ~ 2000 samples) exceeds practical warmup windows -- so they
    run OUTSIDE the sequential loop as exact block-parallel first-order
    scans (see pallas/am_backend_scan.py); only the feedback states live
    in the chunked loop."""
    g, y2p, mode, timer = st.agc
    theta, freq = st.pll
    yr = xr * g
    yi = xi * g
    y2 = yr * yr + yi * yi
    y2p = (1.0 - p.agc.alpha) * y2p + p.agc.alpha * y2
    g_new = jnp.minimum(g * jnp.exp(-0.5 * p.agc.alpha * jnp.log(y2p + 1e-30)), 1e6)
    g = jnp.where(p.agc.locked, g, g_new)
    rssi = -20.0 * jnp.log10(jnp.maximum(g, 1e-30))
    high = rssi > p.agc.threshold
    mode, timer = _fsm_step(mode, timer, high, p.agc.timeout, p.agc.squelch)
    zero = (mode == kagc.SQ_ENABLED) | (mode == kagc.SQ_SIGNALLO)
    outr = jnp.where(zero, 0.0, yr * p.agc.scale)
    outi = jnp.where(zero, 0.0, yi * p.agc.scale)
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    vr = outr * c + outi * s
    vi = outi * c - outr * s
    err = atan2(vi, vr) * p.use_pll
    freq = freq + p.pll_alpha * err
    theta = jnp.mod(theta + p.pll_beta * err + freq + np.pi, 2.0 * np.pi) - np.pi
    return FrontState(AgcState(g, y2p, mode, timer), PllState(theta, freq)), (vr, mode)


def front_exact(p: AmBackendParams, st: FrontState, x):
    """Exact sequential AGC+PLL front (for tail fixes and testing)."""

    def step(s, xn):
        return front_sample_step(p, s, xn.real.astype(jnp.float32),
                                 xn.imag.astype(jnp.float32))

    return jax.lax.scan(step, st, x)


def front_chunked(p: AmBackendParams, st: FrontState, x,
                  chunk: int, warmup: int):
    """Chunk-parallel AGC+PLL front (XLA): the warmup-chunk scheme of
    kernels/agc.agc_apply_chunked applied to the combined front step.
    x: (N,) complex64. Returns (FrontState, (vr, modes)). Warmup must
    exceed ~10x the slowest loop memory (PLL: 1/sqrt(bw) once near lock,
    AGC: 1/alpha) -- derive it with kernels/warmup.warmup_for from the
    static loop bandwidths; it is deliberately NOT defaulted here."""
    from .pll import _chunked_scan
    fn = lambda s, xs: front_exact(p, s, xs)
    bcast = lambda s, n: jax.tree.map(lambda v: jnp.broadcast_to(v, (n,)), s)
    sel = lambda f: jax.tree.map(lambda v: v[-1], f)
    return _chunked_scan(fn, bcast, sel, st, x, chunk, warmup)
