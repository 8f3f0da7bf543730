"""PLL carrier-recovery scans (JAX/XLA).

The genuinely sequential core of the composite demodulators
(SURVEY.md section 3.4 / section 7 hard part 1): the per-sample feedback
loop of reference demod.hpp:54-84 (FMStereo pilot) and demod.hpp:133-152
(BroadcastAM carrier). Everything LTI around the loop is hoisted out and
runs block-parallel; only the loop itself is a lax.scan, carrying
(theta, freq) [+ the one-pole phase-error filter for FMStereo].

PLL gains follow the liquid nco convention (tpudsp/kernels/nco.py):
freq gain alpha = bw, phase gain beta = sqrt(bw); update order per
reference demod.hpp:62-73: mix with current theta, compute error,
pll_step, then step (theta += freq).

For throughput, ``pll_scan_chunked`` applies the same warmup-chunk
parallelization as the AGC (contraction argument: the loop's memory is
~1/beta samples once near lock).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import numpy as np

TWO_PI = np.float32(2.0 * np.pi)


class PllState(NamedTuple):
    theta: jnp.ndarray  # f32, radians (wrapped)
    freq: jnp.ndarray   # f32, radians/sample


def pll_init() -> PllState:
    return PllState(theta=jnp.float32(0.0), freq=jnp.float32(0.0))


def _wrap(t):
    return jnp.mod(t + np.pi, TWO_PI) - np.pi


def pll_carrier_scan(state: PllState, x, bw: float):
    """Track the carrier of ``x``: per sample v = x e^{-j theta},
    err = arg(v), pll_step(err), theta += freq.
    Returns (new_state, theta_per_sample). Use the returned thetas to mix
    any other path elementwise afterwards (reference demod.hpp:141-148
    mixes the delayed wideband path with the same theta)."""
    alpha = jnp.float32(bw)
    beta = jnp.float32(np.sqrt(bw))

    def step(st, xn):
        th, fr = st
        v = xn * jnp.exp(-1j * th)
        err = jnp.arctan2(v.imag, v.real)  # scalar scan step: libm wins here
        fr = fr + alpha * err
        th_next = _wrap(th + beta * err + fr)
        return PllState(th_next, fr), th

    new_state, thetas = jax.lax.scan(step, state, x)
    return new_state, thetas


class StereoPilotState(NamedTuple):
    p: jnp.ndarray        # c64: first smoothing stage (pilot phasor at DC)
    p2: jnp.ndarray       # c64: second smoothing stage (cascade)
    phase_u: jnp.ndarray  # u32: running phase of the nominal 19 kHz mixer


def stereo_pilot_init() -> StereoPilotState:
    return StereoPilotState(jnp.complex64(0.0), jnp.complex64(0.0), jnp.uint32(0))


def _onepole_scan(rho: float, carry, v):
    """Complex one-pole p[n] = rho p[n-1] + (1-rho) v[n] with carried
    entry state, run as the matmul-blocked first-order scan (kernels/iir
    first_order_apply_blocked_c64: same results class as the f32
    associative scan). rho must be a static Python float."""
    from .iir import first_order_apply_blocked_c64
    _, y = first_order_apply_blocked_c64(1.0 - rho, rho, carry, v)
    return y


def stereo_pilot_apply(state: StereoPilotState, s, dtheta_u32,
                       rho: float = 0.999, with_metrics: bool = False):
    """FMStereo pilot recovery + L-R subband demodulation, fully
    block-parallel (no sequential PLL).

    Re-architecture of the reference's per-sample pilot NCO loop
    (demod.hpp:54-84). The reference drives an NCO PLL from a one-pole-
    filtered arg() of the once-mixed composite; measured from a cold start
    that loop diverges (its pilot NCO frequency runs far beyond Nyquist on a
    clean synthetic stereo signal -- tests/test_oracle_composite.py
    demonstrates this against the sample-serial reference-topology oracle),
    and even when force-locked its L-R term Re(s e^{-2j theta}) demodulates
    the subband at half scale and off phase, measuring ~1.4 dB separation.
    SURVEY.md Q3 directs matching the documented *intent* -- decode the
    38 kHz DSB subband coherently with the 19 kHz pilot -- so this framework
    uses the classic pilot-squaring receiver, which is exact and
    embarrassingly parallel:

        z[n] = s[n] * e^{-j w_p n}            (nominal 19 kHz mix, uint32 NCO)
        p[n] = onepole(onepole(z))            (cascade of two one-poles, each
                                               a first-order assoc scan --
                                               block-parallel; the cascade's
                                               -40 dB/dec rolloff keeps audio
                                               and subband energy out of the
                                               pilot phase estimate)
        u[n] = p[n]/|p[n]|                    (unit pilot phasor, phase phi)
        lr[n] = 2 s[n] Re(u[n]^2 e^{2j w_p n})  (coherent 38 kHz demod,
                                                 full-scale L-R)

    s: (N,) float32 composite baseband; dtheta_u32: uint32 per-sample pilot
    phase increment (2 pi 19000/iq_rate). Returns (new_state, lr float32).
    The smoother bandwidth (1-rho) need only exceed the pilot's frequency
    tolerance (broadcast pilots are within a few Hz), and its settling sets
    the stereo acquisition time (~2/(1-rho) samples). Follow with
    ``stereo_matrix_lowpass`` to keep only the audio band.

    with_metrics=True additionally returns (pilot_level, pilot_freq):
    the smoothed pilot amplitude at block end (lock indicator) and the
    amplitude-weighted mean rotation rate of the pilot phasor over the
    block tail (rad/sample offset from the nominal 19 kHz)."""
    n = s.shape[0]
    k = jnp.arange(n, dtype=jnp.uint32)
    th_u = state.phase_u + k * dtheta_u32
    theta = th_u.astype(jnp.float32) * jnp.float32(2.0 * np.pi / 4294967296.0)
    osc = jnp.exp(-1j * theta).astype(jnp.complex64)
    z = s.astype(jnp.complex64) * osc

    p1 = _onepole_scan(float(rho), state.p, z)
    p = _onepole_scan(float(rho), state.p2, p1)
    mag = jnp.abs(p)
    u = jnp.where(mag > 1e-6, p / (mag + 1e-12), jnp.zeros_like(p))
    ref38 = u * u * jnp.conj(osc) * jnp.conj(osc)  # e^{+2j w_p n} u^2
    lr = 2.0 * s * ref38.real
    new_state = StereoPilotState(p=p1[-1], p2=p[-1],
                                 phase_u=state.phase_u + jnp.uint32(n) * dtheta_u32)
    if not with_metrics:
        return new_state, lr.astype(jnp.float32)
    tail = p[-max(n // 4, 2):]
    rot = tail[1:] * jnp.conj(tail[:-1])
    pilot_freq = jnp.angle(jnp.sum(rot)).astype(jnp.float32)
    # |p| tracks pilot_amplitude/2 (one-sided mix of a real tone); report
    # the full pilot amplitude in composite units
    pilot_level = (2.0 * mag[-1]).astype(jnp.float32)
    return new_state, lr.astype(jnp.float32), (pilot_level, pilot_freq)


def stereo_matrix_lowpass(h_aud, tail, s, lr):
    """Audio-band lowpass + stereo matrix in one complex FIR pass.

    The composite s still carries the pilot (19 kHz) and subband images
    (>=23 kHz), and lr carries everything the coherent 38 kHz demod mixed
    out of band; a single real-tap FIR over the packed complex signal
    s + j lr filters both paths with identical group delay, so the matrix
    stays balanced. Returns (new_tail, (L, R)) with L = s_f + lr_f,
    R = s_f - lr_f. Design taps with firdes.stereo_audio_lowpass."""
    from . import fir as kfir
    tail, c = kfir.fir_apply(h_aud, tail, (s + 1j * lr).astype(jnp.complex64))
    return tail, (c.real + c.imag, c.real - c.imag)


def _chunked_scan(scan_fn, state_bcast, state_sel_last, state, x, chunk, warmup):
    """Generic warmup-chunk parallelization of a contractive scan.
    scan_fn(state, xs) -> (state', ys). Chunks are vmapped; chunk i's entry
    state is re-derived by running the scan over the `warmup` samples
    preceding it, started from the carried block-start state. Samples before
    the block start are masked out of the warmup (state passthrough), so
    early chunks with short history get exact entry states."""
    n = x.shape[0]
    if n <= chunk + warmup:
        return scan_fn(state, x)
    nchunks = -(-n // chunk)
    pad = nchunks * chunk - n
    xp = jnp.pad(x, (0, pad))
    xc = xp.reshape(nchunks, chunk)
    wpad = jnp.concatenate([jnp.zeros((warmup,), x.dtype), xp])
    vpad = jnp.concatenate([jnp.zeros((warmup,), bool), jnp.ones((xp.shape[0],), bool)])
    if warmup <= chunk:
        # window i = wpad[i*chunk : i*chunk+warmup] is exactly the first
        # `warmup` columns of chunk-row i -- a reshape+slice, no gather.
        # The gather's (nchunks, warmup) index matrix lowers as a DENSE
        # i32 constant in the program (measured: 1.18 MB of a 1.36 MB
        # WBFM stereo program).
        wwin = wpad[:nchunks * chunk].reshape(nchunks, chunk)[:, :warmup]
        wval = vpad[:nchunks * chunk].reshape(nchunks, chunk)[:, :warmup]
    else:
        widx = ((jnp.arange(nchunks) * chunk)[:, None]
                + jnp.arange(warmup)[None, :])
        wwin = wpad[widx]
        wval = vpad[widx]

    def warm_fn(st0, xs_valid):
        xs, valid = xs_valid

        def one(st, xv):
            xn, v = xv
            st2, _ = scan_fn(st, xn[None])
            return jax.tree.map(lambda a, b: jnp.where(v, a, b), st2, st), ()

        st_out, _ = jax.lax.scan(one, st0, (xs, valid))
        return st_out

    neutral = state_bcast(state, nchunks)
    vscan = jax.vmap(scan_fn, in_axes=(0, 0))
    entry = jax.vmap(warm_fn, in_axes=(0, 0))(neutral, (wwin, wval))
    entry = jax.tree.map(lambda e, s: e.at[0].set(s), entry, state)
    final, ys = vscan(entry, xc)
    ys = jax.tree.map(lambda y: y.reshape(-1)[:n], ys)
    new_state = state_sel_last(final)
    if pad:
        last = (nchunks - 1) * chunk
        st0 = jax.tree.map(lambda e: e[-1], entry)
        new_state, _ = scan_fn(st0, x[last:])
    return new_state, ys


def pll_carrier_scan_chunked(state: PllState, x, bw: float,
                             chunk: int | None = None,
                             warmup: int | None = None):
    """Chunk-parallel version of pll_carrier_scan (documented approximation:
    exact after lock to ~exp(-sqrt(bw)*warmup); tested vs the exact scan).
    warmup defaults to the derivation in kernels/warmup.py (>= 12/sqrt(bw)),
    never a frozen constant."""
    from .warmup import chunk_for, warmup_for
    if warmup is None:
        warmup = warmup_for(pll_bw=bw, minimum=2048)
    if chunk is None:
        chunk = chunk_for(warmup, base=2048)
    fn = lambda st, xs: pll_carrier_scan(st, xs, bw)
    bcast = lambda s, n: jax.tree.map(lambda v: jnp.broadcast_to(v, (n,)), s)
    sel = lambda f: jax.tree.map(lambda v: v[-1], f)
    return _chunked_scan(fn, bcast, sel, state, x, chunk, warmup)
