"""AGC gain loop + squelch FSM as a scan with explicit state (JAX/XLA).

Equivalent of liquid ``agc_crcf`` plus the reference wrapper's squelch
polling loop (reference agc.hpp:109-128). Per sample:

    y        = x * g
    y2p      = (1 - alpha) * y2p + alpha * |y|^2
    g       *= exp(-alpha/2 * ln(y2p))       (unless locked; clamped to 1e6)
    rssi     = -20 log10 g
    FSM step on (rssi > threshold)           (states per agc_docs.cpp:53-72)
    output   = 0 in states ENABLED(1) / SIGNALLO(5), else y * scale

The gain recurrence is a genuine feedback loop, so the exact path is a
jax.lax.scan (serial in time, batched over channels). For throughput the
``chunked`` path exploits contraction: the loop forgets its past at rate
alpha per sample, so each chunk re-derives its entry state from a warmup
window of the previous chunk's samples, and all chunks run in parallel
(vmapped scan). Warmup W gives a state error O(exp(-alpha * W)):
W >= 10/alpha keeps it below -86 dB. The squelch callback becomes data:
the kernel returns the per-sample FSM state tensor and the host fires
``onRise`` after the block (SURVEY.md section 3.5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Squelch states -- numbering is the reference's documented contract
# (agc_docs.cpp:53-72).
SQ_UNKNOWN = 0
SQ_ENABLED = 1
SQ_RISE = 2
SQ_SIGNALHI = 3
SQ_FALL = 4
SQ_SIGNALLO = 5
SQ_TIMEOUT = 6
SQ_DISABLED = 7


class AgcState(NamedTuple):
    g: jnp.ndarray          # f32 scalar, linear gain
    y2p: jnp.ndarray        # f32 scalar, smoothed output power
    sq_mode: jnp.ndarray    # i32 scalar, squelch FSM state
    sq_timer: jnp.ndarray   # i32 scalar, SIGNALLO countdown


class AgcParams(NamedTuple):
    alpha: jnp.ndarray       # f32, loop bandwidth
    locked: jnp.ndarray      # bool, freeze gain updates (AGC.lock)
    squelch: jnp.ndarray     # bool, squelch enabled
    threshold: jnp.ndarray   # f32, squelch threshold dB
    timeout: jnp.ndarray     # i32, SIGNALLO -> TIMEOUT countdown
    scale: jnp.ndarray       # f32, output scale (AGC.scale)


def agc_init(squelch: bool = False, timeout: int = 100) -> AgcState:
    return AgcState(
        g=jnp.float32(1.0),
        y2p=jnp.float32(1.0),
        sq_mode=jnp.int32(SQ_ENABLED if squelch else SQ_DISABLED),
        sq_timer=jnp.int32(timeout),
    )


def make_params(
    alpha=0.01, locked=False, squelch=False, threshold=0.0, timeout=100, scale=1.0
) -> AgcParams:
    return AgcParams(
        alpha=jnp.float32(alpha),
        locked=jnp.asarray(locked, dtype=bool),
        squelch=jnp.asarray(squelch, dtype=bool),
        threshold=jnp.float32(threshold),
        timeout=jnp.int32(timeout),
        scale=jnp.float32(scale),
    )


def _fsm_step(mode, timer, high, timeout, squelch_on):
    """One squelch FSM transition, branch-free."""
    is_ = lambda m: mode == m
    next_mode = mode
    next_mode = jnp.where(
        is_(SQ_UNKNOWN) | is_(SQ_ENABLED),
        jnp.where(high, SQ_RISE, SQ_ENABLED),
        next_mode,
    )
    next_mode = jnp.where(is_(SQ_RISE), jnp.where(high, SQ_SIGNALHI, SQ_FALL), next_mode)
    next_mode = jnp.where(is_(SQ_SIGNALHI) & ~high, SQ_FALL, next_mode)
    next_mode = jnp.where(is_(SQ_FALL), jnp.where(high, SQ_SIGNALHI, SQ_SIGNALLO), next_mode)
    timer = jnp.where(is_(SQ_FALL) & ~high, timeout, timer)
    in_lo = is_(SQ_SIGNALLO)
    timer = jnp.where(in_lo & ~high, timer - 1, timer)
    next_mode = jnp.where(in_lo, jnp.where(high, SQ_SIGNALHI, jnp.where(timer <= 0, SQ_TIMEOUT, SQ_SIGNALLO)), next_mode)
    next_mode = jnp.where(is_(SQ_TIMEOUT), SQ_ENABLED, next_mode)
    next_mode = jnp.where(squelch_on, next_mode, SQ_DISABLED).astype(jnp.int32)
    return next_mode, timer.astype(jnp.int32)


def _sample_step(params: AgcParams, state: AgcState, x):
    g, y2p, mode, timer = state
    y = x * g.astype(x.dtype)
    y2 = (y * jnp.conj(y)).real.astype(jnp.float32)
    y2p = (1.0 - params.alpha) * y2p + params.alpha * y2
    g_new = g * jnp.exp(-0.5 * params.alpha * jnp.log(y2p + 1e-30))
    g_new = jnp.minimum(g_new, 1e6)
    g = jnp.where(params.locked, g, g_new)
    rssi = -20.0 * jnp.log10(jnp.maximum(g, 1e-30))
    high = rssi > params.threshold
    mode, timer = _fsm_step(mode, timer, high, params.timeout, params.squelch)
    zero = (mode == SQ_ENABLED) | (mode == SQ_SIGNALLO)
    out = jnp.where(zero, jnp.zeros_like(y), y * params.scale.astype(y.real.dtype))
    return AgcState(g, y2p, mode, timer), (out, mode)


def agc_apply(params: AgcParams, state: AgcState, x):
    """Exact sequential AGC over a 1-D block (lax.scan).
    Returns (new_state, (y, modes))."""

    def step(st, xn):
        return _sample_step(params, st, xn)

    new_state, (y, modes) = jax.lax.scan(step, state, x)
    return new_state, (y, modes)


def agc_apply_chunked(params: AgcParams, state: AgcState, x, chunk: int, warmup: int):
    """Throughput AGC: chunks run in parallel, each warmed up on the tail of
    its predecessor's input. Approximation error ~ exp(-alpha * warmup)
    relative (documented; tested >= 60 dB vs agc_apply). The first chunk uses
    the true carried state, so short blocks degrade gracefully to exact.

    Squelch FSM state across chunk boundaries is re-derived during warmup as
    well; the FSM follows rssi with hysteresis bounded by `timeout`, so
    warmup >= timeout + 10/alpha reproduces it except within `warmup` samples
    of a squelch edge. Returns (new_state, (y, modes)).
    """
    n = x.shape[0]
    if n <= chunk + warmup:
        return agc_apply(params, state, x)
    nchunks = -(-n // chunk)
    pad = nchunks * chunk - n
    xp = jnp.pad(x, (0, pad))
    xc = xp.reshape(nchunks, chunk)
    # warmup windows: for chunk i, the last `warmup` samples before it.
    # Samples before the block start are padding and are *masked out* of the
    # warmup scan (state passes through unchanged), so early chunks with
    # short history get their entry state exactly.
    wpad = jnp.concatenate([jnp.zeros((warmup,), x.dtype), xp])
    vpad = jnp.concatenate(
        [jnp.zeros((warmup,), bool), jnp.ones((xp.shape[0],), bool)]
    )
    if warmup <= chunk:
        # window i = wpad[i*chunk : i*chunk+warmup] = the first `warmup`
        # columns of chunk-row i: reshape+slice instead of a gather whose
        # (nchunks, warmup) index matrix lowers as a dense i32 constant
        # (see kernels/pll._chunked_scan)
        wwin = wpad[:nchunks * chunk].reshape(nchunks, chunk)[:, :warmup]
        wval = vpad[:nchunks * chunk].reshape(nchunks, chunk)[:, :warmup]
    else:
        starts = jnp.arange(nchunks) * chunk
        widx = starts[:, None] + jnp.arange(warmup)[None, :]
        wwin = wpad[widx]  # (nchunks, warmup): [i*chunk-warmup, i*chunk)
        wval = vpad[widx]

    # Entry state for chunk i: run the loop over its warmup window starting
    # from the carried block-start state (exact for chunks whose whole
    # history fits in the window; contraction bounds the rest).
    neutral = AgcState(
        g=jnp.broadcast_to(state.g, (nchunks,)),
        y2p=jnp.broadcast_to(state.y2p, (nchunks,)),
        sq_mode=jnp.broadcast_to(state.sq_mode, (nchunks,)),
        sq_timer=jnp.broadcast_to(state.sq_timer, (nchunks,)),
    )

    def run(st0, xs):
        def step(st, xn):
            return _sample_step(params, st, xn)
        return jax.lax.scan(step, st0, xs)

    def run_masked(st0, xs_and_valid):
        def step(st, xv):
            xn, valid = xv
            st2, _ = _sample_step(params, st, xn)
            st3 = jax.tree.map(lambda a, b: jnp.where(valid, a, b), st2, st)
            return st3, ()
        st_out, _ = jax.lax.scan(step, st0, xs_and_valid)
        return st_out, ()

    vrun = jax.vmap(run, in_axes=(0, 0))
    entry, _ = jax.vmap(run_masked, in_axes=(0, 0))(neutral, (wwin, wval))
    # chunk 0 has no (real) warmup data: use the true carried state
    entry = AgcState(
        g=entry.g.at[0].set(state.g),
        y2p=entry.y2p.at[0].set(state.y2p),
        sq_mode=entry.sq_mode.at[0].set(state.sq_mode),
        sq_timer=entry.sq_timer.at[0].set(state.sq_timer),
    )
    final, (y, modes) = vrun(entry, xc)
    y = y.reshape(-1)[:n]
    modes = modes.reshape(-1)[:n]
    new_state = AgcState(
        g=final.g[-1], y2p=final.y2p[-1], sq_mode=final.sq_mode[-1], sq_timer=final.sq_timer[-1]
    )
    if pad:
        # final chunk was zero-padded; re-derive the carried state exactly
        # from the unpadded tail of the last chunk
        last_start = (nchunks - 1) * chunk
        tail = x[last_start:]
        st0 = AgcState(
            g=entry.g[-1], y2p=entry.y2p[-1], sq_mode=entry.sq_mode[-1], sq_timer=entry.sq_timer[-1]
        )
        new_state, _ = run(st0, tail)
    return new_state, (y, modes)
