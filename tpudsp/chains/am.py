"""AM receiver chain (BASELINE.json config 1; reference README.md:41-58).

Reference chain (per-op, 5 Python->C++ crossings per block, SURVEY.md 3.3):

    pcm = deemph( am( agc( resample( bandpass(iq) ))))

Here the whole chain is ONE jitted function over a fixed-size IQ block with
an explicit state pytree (SURVEY.md section 7 core decision 1). Two
execution plans:

- ``composed``: each stage runs as its kernel, in reference order.
- ``fused`` (default): everything upstream of the decimating resampler is
  LTI, so the bandpass IIR (as its truncated impulse response) is folded
  into the resampler's polyphase prototype, and the combined filter is
  evaluated *only at the 48 kHz output points* as a strided convolution --
  for the 2 Msps -> 48 kHz chain this removes ~98% of the filtering work.
  Requires a rational rate (output positions repeat with period P); the
  class falls back to ``composed`` otherwise. LTI commutation keeps the
  result equal to the composed plan within float tolerance (tested).

The sequential parts (AGC loop, carrier PLL) run at the *output* rate
(48 kHz), as in the reference chain, and use the chunk-parallel scan
kernels, so the per-sample dependence never touches the 2 Msps rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..design import firdes, iirdes
from ..kernels import agc as kagc
from ..kernels import ampmodem as kam
from ..kernels import decimate as kdec
from ..kernels import fir as kfir
from ..kernels import iir as kiir
from ..kernels import pll as kpll
from ..kernels import resamp as krs
from ..kernels import warmup as kwarm
from . import metrics as kmet
from .metrics import BlockMetrics


@dataclass(frozen=True)
class AMConfig:
    bandwidth: float = 15000.0      # bandpass cutoff in Hz (README.md:48)
    iq_rate: float = 2_000_000.0
    pcm_rate: float = 48_000.0
    order: int = 8                  # cheby2 order (README.md:48)
    modulation: float = 0.5
    carrier: bool = True
    agc_bandwidth: float = 0.01
    agc_scale: float = 0.01
    # Squelch gating in the chain's AGC (reference agc.hpp:109-128,
    # agc_docs.cpp:53-72): below-threshold audio is zeroed by the FSM and
    # the per-sample mode tensor lands in BlockMetrics.squelch_modes;
    # host-side callbacks (the reference's onRise) fire from that tensor
    # after the block via StreamRuntime(on_event=...) / squelch_events().
    squelch: bool = False
    squelch_threshold: float = 0.0  # dB (rssi = -20 log10 gain)
    squelch_timeout: int = 100      # SIGNALLO -> TIMEOUT countdown samples
    resamp_m: int = 13
    resamp_npfb: int = 64

    @property
    def rate(self) -> float:
        return self.pcm_rate / self.iq_rate


class AMState(NamedTuple):
    fir_tail: jnp.ndarray       # bandpass TIR tail (composed) / zeros (fused)
    rs_tail: jnp.ndarray        # resampler input tail
    agc: kagc.AgcState
    am: kam.AmpDemodState
    deemph: jnp.ndarray


class AMParams(NamedTuple):
    h_bp: jnp.ndarray           # bandpass truncated impulse response
    H_rs: jnp.ndarray           # polyphase bank (npfb+1, 2m) [composed]
    taps_fused: jnp.ndarray     # (P, Kc, Q) blocked flipped fused taps [fused]
    q: jnp.ndarray              # (n_out,) window starts for this block size
    frac: jnp.ndarray           # (n_out,) fractional phases
    h_hilb: jnp.ndarray
    agc: kagc.AgcParams
    deemph_b0: jnp.ndarray
    deemph_a: jnp.ndarray
    mod: jnp.ndarray
    u8_dc: object = None        # (P,) per-phase tap sums (u8 wire format)


def _rational(rate: float, max_den: int = 10000):
    f = Fraction(rate).limit_denominator(max_den)
    if abs(float(f) - rate) < 1e-12:
        return f.numerator, f.denominator  # P outputs per Q inputs
    return None


def build(cfg: AMConfig, block_len: int, input_format: str = "c64"):
    """Design-time: build (params, init_state, n_out). block_len must make
    the output count integral (block_len * rate integer) so the jitted step
    has static shapes; the class wrapper enforces this.

    input_format='i16' plans for RAW interleaved int16 IQ (the radio's
    native format, reference utility.hpp:61-69): the 1/32767 scale folds
    into the fused taps and the carried tail stays int16, so the chain
    reads 4 B/sample from HBM instead of 8 (fused plan only)."""
    rate = cfg.rate
    n_out_f = block_len * rate
    n_out = int(round(n_out_f))
    if abs(n_out_f - n_out) > 1e-9:
        raise ValueError(
            f"block_len {block_len} * rate {rate} must be integral, got {n_out_f}"
        )
    # bandpass (reference README uses cheby2 lowpass of the +/- bandwidth)
    sos = iirdes.iirdes_sos("cheby2", "lowpass", cfg.order,
                            cfg.bandwidth / cfg.iq_rate, As=60.0, Ap=0.5)
    h_bp = iirdes.sos_impulse_response(sos, tol=1e-11)
    if h_bp is None:
        raise ValueError("bandpass impulse response does not truncate")
    # resampler bank
    fc = 0.45 * rate
    H = firdes.resamp_bank(cfg.resamp_m, fc, 60.0, cfg.resamp_npfb)
    # block output plan (tau = 0 cycles exactly when n_out integral)
    _, q, frac, _ = krs.plan(0.0, block_len, rate)
    assert len(q) == n_out

    # fused taps: bandpass TIR folded into each needed polyphase row
    # (kernels/decimate.py plan_fused_frontend documents the alignment;
    # the fused==composed equivalence test pins it down)
    taps_fused = np.zeros((1, 1, 1), np.float32)
    pq = _rational(rate)
    if pq is not None:
        P, Q = pq
        taps_raw, _, offs = kdec.plan_fused_frontend(H, h_bp, P, Q)
        # offsets folded into the taps: ONE matmul pass over the input
        # serves all P phases (kernels/decimate.fold_offsets)
        taps_fused = kdec.fold_offsets(taps_raw, offs, Q)
    u8_dc = None
    if input_format in ("i16", "u8"):
        if pq is None:
            raise ValueError(f"input_format={input_format!r} needs the "
                             "fused plan (rational rate)")
        if input_format == "i16":
            taps_fused = taps_fused * np.float32(1.0 / 32767.0)
        else:  # u8: affine (b-127.5)/127.5 -> scaled taps + per-phase DC
            u8_dc = jnp.asarray(
                taps_fused.reshape(taps_fused.shape[0], -1).sum(axis=1),
                jnp.float32)
            taps_fused = taps_fused * np.float32(1.0 / 127.5)
    elif input_format != "c64":
        raise ValueError(f"unknown input_format {input_format!r} "
                         "(use 'c64', 'i16' or 'u8')")

    params = AMParams(
        h_bp=jnp.asarray(h_bp, jnp.float32),
        H_rs=jnp.asarray(H, jnp.float32),
        taps_fused=jnp.asarray(taps_fused),
        q=jnp.asarray(q),
        frac=jnp.asarray(frac),
        h_hilb=jnp.asarray(firdes.hilbert_fir(kam.HILB_M, 60.0), jnp.float32),
        agc=kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale,
                             squelch=cfg.squelch,
                             threshold=cfg.squelch_threshold,
                             timeout=cfg.squelch_timeout),
        deemph_b0=jnp.float32(iirdes.deemphasis_coeffs(cfg.pcm_rate)[0]),
        deemph_a=jnp.float32(iirdes.deemphasis_coeffs(cfg.pcm_rate)[1]),
        mod=jnp.float32(cfg.modulation),
        u8_dc=u8_dc,
    )
    ntaps_rs = 2 * cfg.resamp_m
    kf = len(h_bp) + ntaps_rs - 1  # fused filter length
    kf_full = max(ntaps_rs, kf)
    if input_format == "i16":
        rs_tail = jnp.zeros((kf_full, 2), jnp.int16)
    elif input_format == "u8":
        # 127 ~ zero signal to within half an LSB (127.5 unrepresentable)
        rs_tail = jnp.full((kf_full, 2), 127, jnp.uint8)
    else:
        rs_tail = jnp.zeros((kf_full,), jnp.complex64)
    state = AMState(
        fir_tail=kfir.fir_init(len(h_bp), jnp.complex64),
        rs_tail=rs_tail,
        agc=kagc.agc_init(squelch=cfg.squelch, timeout=cfg.squelch_timeout),
        am=kam.ampdemod_init(),
        deemph=jnp.float32(0.0),
    )
    return params, state, n_out


def _back_end(params: AMParams, state: AMState, baseband, cfg: AMConfig, exact: bool,
              backend: str = "xla"):
    """AGC -> AmpModem -> de-emphasis at the pcm rate.

    backend='pallas' runs the feedback core (AGC + squelch + carrier PLL)
    as one Pallas kernel (tpudsp/pallas/am_backend_scan.py) instead of
    the two XLA chunked scans; only valid with exact=False."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r} (use 'xla' or 'pallas')")
    if backend == "pallas" and exact:
        raise ValueError("backend='pallas' requires exact=False "
                         "(the fused kernel is the chunked path)")
    # warmup derived from the loops actually in the chunked scan
    # (kernels/warmup.py): AGC gain loop + carrier PLL when present
    warmup = kwarm.warmup_for(
        agc_alpha=cfg.agc_bandwidth,
        pll_bw=kam.PLL_BW if cfg.carrier else None,
        squelch_timeout=cfg.squelch_timeout if cfg.squelch else 0)
    if backend == "pallas":
        from ..kernels import am_backend as kab
        from ..pallas.am_backend_scan import front_chunked_pallas
        p = kab.make_params(params.agc, params.mod, params.deemph_b0,
                            params.deemph_a, carrier=cfg.carrier)
        st = jax.tree.map(lambda v: jnp.asarray(v)[None],
                          kab.FrontState(state.agc, state.am.pll))
        front, (vr, modes) = front_chunked_pallas(
            p, st, baseband[None, :], chunk=kwarm.chunk_for(warmup),
            warmup=warmup)
        front = jax.tree.map(lambda v: v[0], front)
        agc_state, vr, modes = front.agc, vr[0], modes[0]
        dc = state.am.dc
        audio = vr / params.mod
        if cfg.carrier:
            dc, dc_track = kiir.first_order_apply_blocked(
                1.0 - kam.DC_RHO, kam.DC_RHO, dc, vr)
            audio = (vr - dc_track) / params.mod
        am_state = kam.AmpDemodState(pll=front.pll, dc=dc, c2r=state.am.c2r)
    else:
        agc_fn = kagc.agc_apply if exact else partial(
            kagc.agc_apply_chunked, chunk=kwarm.chunk_for(warmup),
            warmup=warmup)
        agc_state, (z, modes) = agc_fn(params.agc, state.agc, baseband)
        am_state, audio = kam.ampdemod_apply(
            state.am, z, params.h_hilb, params.mod, "dsb", cfg.carrier,
            exact_pll=exact)
    # de-emphasis coefficients re-derived at trace time (cfg is static):
    # the blocked scan takes them as Python floats
    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.pcm_rate)
    d_state, pcm = kiir.first_order_apply_blocked(
        b0_de, a_de, state.deemph, audio)
    return agc_state, am_state, d_state, pcm, modes


def _chain_metrics(agc_state, am_state) -> BlockMetrics:
    return BlockMetrics(
        rssi=kmet.rssi_db(agc_state.g),
        squelch_modes=None,  # filled by the step (full per-sample tensor)
        pll_freq=am_state.pll.freq,
        # block lengths are chosen to make the output count integral, so
        # the carried fractional credit is 0 by construction (SURVEY Q8)
        resamp_credit=jnp.float32(0.0),
    )


def am_step_composed(params: AMParams, state: AMState, iq, *, cfg: AMConfig,
                     exact: bool = False, backend: str = "xla"):
    """Reference-ordered chain: bandpass -> resample -> agc -> am -> deemph.
    Returns (state, (pcm, BlockMetrics))."""
    with jax.named_scope("am.front.bandpass"):
        fir_tail, bb = kfir.fir_apply(params.h_bp, state.fir_tail, iq)
    ntaps = params.H_rs.shape[1]
    with jax.named_scope("am.front.resample"):
        rs_tail, y48 = krs.resamp_apply(
            params.H_rs, state.rs_tail[-ntaps:], bb, params.q, params.frac)
        rs_tail_full = jnp.concatenate([state.rs_tail, bb])[-state.rs_tail.shape[0]:]
    with jax.named_scope("am.back_end"):
        agc_state, am_state, d_state, pcm, modes = _back_end(
            params, state, y48, cfg, exact, backend)
    new_state = AMState(fir_tail, rs_tail_full, agc_state, am_state, d_state)
    metrics = _chain_metrics(agc_state, am_state)._replace(squelch_modes=modes)
    return new_state, (pcm, metrics)


def am_step_fused(params: AMParams, state: AMState, iq, *, cfg: AMConfig,
                  exact: bool = False, backend: str = "xla"):
    """Fused front end: bandpass+anti-alias+decimate evaluated only at
    output points (output k = j*P + r at input offset j*Q + floor(r*Q/P))
    as P blocked matmuls (tpudsp/kernels/decimate.py). iq may be (N,)
    complex64 or (N, 2) raw int16 when built with input_format='i16'.
    Returns (state, (pcm, BlockMetrics))."""
    P, Q = _rational(cfg.rate)
    n_out = params.q.shape[0]
    nj = n_out // P
    # the fused filter length kf equals the full rs_tail here (build sizes
    # it as max(2m, kf) and kf >= 2m always for a TIR bandpass); taps are
    # offset-folded (build), so one matmul pass serves all P phases
    with jax.named_scope("am.front.fused"):
        if state.rs_tail.ndim == 2 and state.rs_tail.dtype == jnp.uint8:
            rs_tail_full, y48 = kdec.fused_frontend_apply_shared_u8(
                params.taps_fused, params.u8_dc, state.rs_tail, iq, Q, nj)
        elif state.rs_tail.ndim == 2:  # i16 plan: raw tail + input
            rs_tail_full, y48 = kdec.fused_frontend_apply_shared_i16(
                params.taps_fused, state.rs_tail, iq, Q, nj)
        else:
            rs_tail_full, y48 = kdec.fused_frontend_apply_shared(
                params.taps_fused, state.rs_tail, iq, Q, nj)
    with jax.named_scope("am.back_end"):
        agc_state, am_state, d_state, pcm, modes = _back_end(
            params, state, y48, cfg, exact, backend)
    new_state = AMState(state.fir_tail, rs_tail_full, agc_state, am_state, d_state)
    metrics = _chain_metrics(agc_state, am_state)._replace(squelch_modes=modes)
    return new_state, (pcm, metrics)


class AMReceiver:
    """Stateful AM receiver over fixed-size IQ blocks: one jitted step.

    plan='fused' | 'composed'; exact=True uses the exact sequential
    AGC/PLL scans (for verification), exact=False the chunk-parallel ones
    (throughput; default). backend='pallas' runs the whole feedback core
    as one Pallas kernel (pallas/am_backend_scan.py)."""

    def __init__(self, cfg: AMConfig = AMConfig(), block_len: int = 1_000_000,
                 plan: str = "fused", exact: bool = False, backend: str = "xla",
                 input_format: str = "c64"):
        if plan == "fused" and _rational(cfg.rate) is None:
            plan = "composed"
        if input_format in ("i16", "u8") and plan != "fused":
            raise ValueError(f"input_format={input_format!r} requires the "
                             "fused plan")
        self.cfg = cfg
        self.block_len = int(block_len)
        self.plan = plan
        self.input_format = input_format
        from ..utils.hostbuild import host_build
        self.params, self.state, self.n_out = host_build(
            build, cfg, self.block_len, input_format)
        self.metrics = None  # BlockMetrics of the last processed block
        step = am_step_fused if plan == "fused" else am_step_composed
        self._step = jax.jit(partial(step, cfg=cfg, exact=exact, backend=backend))

    def __call__(self, iq):
        from ..utils.profiling import annotate
        if self.input_format in ("i16", "u8"):
            want = jnp.int16 if self.input_format == "i16" else jnp.uint8
            iq = jnp.asarray(iq)
            if iq.dtype != want or iq.ndim != 2 or iq.shape[1] != 2:
                raise TypeError(
                    f"input_format={self.input_format!r} expects (N, 2) "
                    f"{want.__name__} [re, im]; got {iq.dtype} {iq.shape}")
        else:
            iq = jnp.asarray(iq, jnp.complex64)
        if iq.shape[0] != self.block_len:
            raise ValueError(f"expected block of {self.block_len} samples")
        with annotate("AMReceiver.step"):
            self.state, (pcm, metrics) = self._step(self.params, self.state, iq)
        self.metrics = metrics  # chains/metrics.BlockMetrics for this block
        return pcm

    def step_fn(self):
        """(params, state, iq) -> (state, (pcm, BlockMetrics)), jit-ready."""
        return self._step
