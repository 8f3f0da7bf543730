"""Pallas kernel (Triton route): the AM back end's feedback core.

The feedback core (AGC gain loop + squelch FSM + carrier PLL,
kernels/am_backend.front_sample_step) is a long serial recurrence over a
few independent lanes. Lanes are (stream, chunk) pairs of the warmup-chunk
scheme (kernels/am_backend.front_chunked is the XLA twin): chunk i of
stream c re-derives its entry state from the `warmup` samples before it,
then runs its `chunk` samples. XLA runs that as while loops with kernel
launches on every step; here one program per block of LANES lanes runs
the whole loop with the state in registers, in one launch.

Layout: the chunks are stored time-major, (chunk, 1 + NL) with lane j in
column j + 1 and a zero column 0. Because chunk >= warmup, lane j's
warmup window is the tail of the previous lane's chunk (column j), so no
window array is materialized. Per lane, a 0/1 flag says whether a
warmup exists (chunk index > 0) and a valid length masks the zero-padded
time tail of each stream's last chunk, so the final state of that lane
is exact and no tail rescan is needed.

The two LINEAR stages (DC tracker, de-emphasis) stay outside: they are
first-order filters of vr with no feedback into the loop, whose memory
exceeds any practical warmup, so they run exactly as blocked scans
(kernels/iir.first_order_apply_blocked).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..kernels import agc as kagc
from ..kernels.agc import AgcState
from ..kernels.am_backend import AmBackendParams, FrontState, front_sample_step
from ..kernels.pll import PllState

LANES = 32   # lanes per program: one warp, one lane per thread
UNROLL = 8   # steps per loop iteration: their loads issue together


def _params_vector(p: AmBackendParams):
    return jnp.stack([
        p.agc.alpha, p.agc.locked.astype(jnp.float32),
        p.agc.squelch.astype(jnp.float32), p.agc.threshold,
        p.agc.timeout.astype(jnp.float32), p.agc.scale,
        p.pll_alpha, p.pll_beta, p.use_pll,
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
        jnp.float32(0.0)]).astype(jnp.float32)   # 16: a power of two


def _kernel(scal_ref, xr_ref, xi_ref, warm_ref, nval_ref,
            g0, y2p0, mode0, timer0, th0, fr0,
            vr_ref, modes_ref, gN, y2pN, modeN, timerN, thN, frN,
            *, chunk: int, warmup: int):
    s = [scal_ref[i] for i in range(9)]
    p = AmBackendParams(
        agc=kagc.AgcParams(alpha=s[0], locked=s[1] > 0.5, squelch=s[2] > 0.5,
                           threshold=s[3], timeout=s[4].astype(jnp.int32),
                           scale=s[5]),
        pll_alpha=s[6], pll_beta=s[7], use_pll=s[8],
        dc_rho=None, use_dc=None, inv_mod=None, deemph_b0=None,
        deemph_a=None)
    base = pl.program_id(0) * LANES
    lanes = pl.ds(base, LANES)
    # column of lane j is j + 1; column j holds the previous chunk
    own, prev = pl.ds(base + 1, LANES), pl.ds(base, LANES)
    warm_ok = warm_ref[lanes] > 0
    nval = nval_ref[lanes]
    st = FrontState(AgcState(g0[lanes], y2p0[lanes], mode0[lanes],
                             timer0[lanes]),
                    PllState(th0[lanes], fr0[lanes]))

    def keep(ok, new, old):
        return jax.tree.map(lambda a, b: jnp.where(ok, a, b), new, old)

    def warm_body(k, st):
        t0 = k * UNROLL
        rows = [(xr_ref[chunk - warmup + t0 + u, prev],
                 xi_ref[chunk - warmup + t0 + u, prev]) for u in range(UNROLL)]
        for xr, xi in rows:
            st2, _ = front_sample_step(p, st, xr, xi)
            st = keep(warm_ok, st2, st)
        return st

    def main_body(k, st):
        t0 = k * UNROLL
        rows = [(xr_ref[t0 + u, own], xi_ref[t0 + u, own])
                for u in range(UNROLL)]
        for u, (xr, xi) in enumerate(rows):
            st2, (vr, mode) = front_sample_step(p, st, xr, xi)
            vr_ref[t0 + u, lanes] = vr
            modes_ref[t0 + u, lanes] = mode
            st = keep(t0 + u < nval, st2, st)
        return st

    st = lax.fori_loop(0, warmup // UNROLL, warm_body, st)
    st = lax.fori_loop(0, chunk // UNROLL, main_body, st)
    gN[lanes] = st.agc.g
    y2pN[lanes] = st.agc.y2p
    modeN[lanes] = st.agc.sq_mode
    timerN[lanes] = st.agc.sq_timer
    thN[lanes] = st.pll.theta
    frN[lanes] = st.pll.freq


def _front_call(scal, xr, xi, warm, nval, init, *, chunk, warmup,
                interpret):
    nl = nval.shape[0]
    f32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.float32)
    i32 = lambda shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    out_shape = (f32((chunk, nl)), i32((chunk, nl)),
                 f32((nl,)), f32((nl,)), i32((nl,)), i32((nl,)),
                 f32((nl,)), f32((nl,)))
    return pl.pallas_call(
        partial(_kernel, chunk=chunk, warmup=warmup),
        out_shape=out_shape,
        grid=(nl // LANES,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="am_front_chunked",
    )(scal, xr, xi, warm, nval, *init)


def front_chunked_pallas(params: AmBackendParams, state: FrontState, x, *,
                         chunk: int, warmup: int):
    """Batched chunk-parallel AGC+PLL front in one Pallas kernel.

    x: (C, L) complex64 -- C independent streams with per-stream carried
    state (FrontState leaves shaped (C,)). Same contract as vmapping
    kernels/am_backend.front_chunked over the streams: blocks of at most
    chunk + warmup samples run exactly, longer ones as warmup-chunk
    lanes. Compiled through Triton on CUDA and run by the Pallas
    interpreter on CPU (pallas.on_platform). Returns
    (FrontState (C,), (vr (C, L) f32, modes (C, L) i32))."""
    C, L = x.shape
    if L <= chunk + warmup:
        chunk, warmup = -(-L // UNROLL) * UNROLL, 0
    if warmup > chunk or chunk % UNROLL or warmup % UNROLL:
        raise ValueError(f"need warmup <= chunk, both multiples of {UNROLL};"
                         f" got warmup={warmup}, chunk={chunk}")
    nchunks = -(-L // chunk)
    nl = C * nchunks
    NL = -(-nl // LANES) * LANES
    xp = jnp.pad(x, ((0, 0), (0, nchunks * chunk - L))).reshape(nl, chunk)
    xt = jnp.pad(xp, ((0, NL - nl), (0, 0))).T            # (chunk, NL)
    xt = jnp.pad(xt, ((0, 0), (1, 0)))                     # zero column 0
    ci = jnp.arange(NL) % nchunks                          # chunk index
    real = jnp.arange(NL) < nl
    warm = (real & (ci > 0)).astype(jnp.int32)
    nval = jnp.where(real, jnp.clip(L - ci * chunk, 0, chunk), 0
                     ).astype(jnp.int32)

    def lanes_of(v, dtype):
        return jnp.pad(jnp.repeat(jnp.asarray(v, dtype), nchunks),
                       (0, NL - nl))

    init = (lanes_of(state.agc.g, jnp.float32),
            lanes_of(state.agc.y2p, jnp.float32),
            lanes_of(state.agc.sq_mode, jnp.int32),
            lanes_of(state.agc.sq_timer, jnp.int32),
            lanes_of(state.pll.theta, jnp.float32),
            lanes_of(state.pll.freq, jnp.float32))
    from . import on_platform
    res = on_platform(
        partial(_front_call, chunk=chunk, warmup=warmup),
        _params_vector(params), xt.real.astype(jnp.float32),
        xt.imag.astype(jnp.float32), warm, nval, init)
    vr_t, modes_t = res[0], res[1]
    vr = vr_t.T[:nl].reshape(C, nchunks * chunk)[:, :L]
    modes = modes_t.T[:nl].reshape(C, nchunks * chunk)[:, :L]
    last = jnp.arange(C) * nchunks + (nchunks - 1)
    gN, y2pN, modeN, timerN, thN, frN = (v[last] for v in res[2:])
    front = FrontState(AgcState(gN, y2pN, modeN, timerN), PllState(thN, frN))
    return front, (vr, modes)
