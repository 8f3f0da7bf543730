"""Critically-sampled polyphase FFT channelizer + demod bank
(BASELINE.json config 4: 1024 channels at 100 Msps).

Classic PFB analysis bank:

  x reshaped to frames (M, C); branch p of frame m accumulates
      u[m, p] = sum_t h[t*C + p] * x[(m-t)*C + p]
  which is T shifted elementwise multiply-adds over the (M, C) frame
  matrix, followed by a batched C-point IFFT along the channel axis.
  Output: (M, C) channel matrix at rate fs/C per channel. Carried state:
  the last T-1 frames.

Channel c is centered at frequency c*fs/C (wrapping above Nyquist to
negative frequencies). The per-channel gain is unity in the passband of
the prototype (normalized at design time).

The demod bank then runs vmapped over channels at the decimated rate
(freqdem for FM, envelope for AM) -- same back end as chains/bank.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..design import firdes, iirdes
from ..kernels.fastmath import patan2
from ..kernels import agc as kagc
from ..kernels import am_backend as kab
from ..kernels import ampmodem as kam
from ..kernels import iir as kiir
from ..kernels import precision as kp
from ..kernels import warmup as kwarm
from ..kernels.pll import PllState
from . import metrics as kmet
from .metrics import BlockMetrics

TWO_PI = 2.0 * np.pi


@dataclass(frozen=True)
class ChannelizerConfig:
    nchan: int = 1024
    taps_per_branch: int = 12
    iq_rate: float = 100_000_000.0
    As: float = 60.0
    # prototype cutoff as a fraction of the channel spacing: slightly wider
    # than 0.5 keeps the passband flat across each channel (receive-PFB
    # convention; adjacent-channel overlap is rejected by As in the stopband)
    cutoff_frac: float = 0.55
    # 1 = critically sampled (channel rate fs/C); 2 = 2x oversampled
    # (hop C/2, channel rate 2*fs/C): the channel Nyquist band then spans
    # the FULL channel spacing, so a cutoff_frac up to ~1.0 gives a flat
    # passband across the whole channel with no aliasing at its edges.
    oversample: int = 1
    # PFB branch-accumulation engine. 'shift' (T shifted multiply-adds
    # over the frame matrix) is THE engine: 3.4x faster than 'conv' on
    # the CPU (23.2 vs 6.8 Msamp/s) and its formulation already achieves
    # the one-pass device-memory traffic that motivated 'conv'. 'conv'
    # (ONE depthwise dilated conv pass, _branch_accumulate_conv) is
    # RETAINED AS AN EXPERIMENT only: equality-pinned by
    # test_channelizer, excluded from the bench, refused by the sharded
    # channelizers; not measured on the GPU.
    engine: str = "shift"

    def __post_init__(self):
        if self.oversample not in (1, 2):
            raise ValueError("oversample must be 1 or 2")
        if self.oversample == 2 and self.nchan % 2:
            raise ValueError("2x oversampling needs an even channel count")
        if self.engine not in ("shift", "conv"):
            raise ValueError("engine must be 'shift' or 'conv'")

    @property
    def chan_rate(self):
        return self.iq_rate / self.nchan * self.oversample


class ChannelizerState(NamedTuple):
    tail: jnp.ndarray  # ((T-1)*C + C-1,) complex64: carried raw samples


def build(cfg: ChannelizerConfig, input_format: str = "c64"):
    """input_format='i16' plans for RAW interleaved int16 IQ: the
    1/32767 scale folds into the prototype branches and the carried tail
    stays int16 (2 B/component HBM ingest; see channelize_i16).
    input_format='u8' is the RTL-SDR wire format ((b-127.5)/127.5,
    1 B/component): the 1/127.5 scale folds the same way and the offset
    is subtracted per branch before the channel IFFT."""
    if input_format not in ("c64", "i16", "u8"):
        raise ValueError(f"unknown input_format {input_format!r} "
                         "(use 'c64', 'i16' or 'u8')")
    C, T = cfg.nchan, cfg.taps_per_branch
    L = C * T
    # prototype: cutoff ~ half the channel spacing, unity passband gain
    h = firdes.kaiser_lowpass(L, cfg.cutoff_frac / C, cfg.As)
    h = h / h.sum()
    if input_format == "i16":
        h = h * (1.0 / 32767.0)
    elif input_format == "u8":
        h = h * (1.0 / 127.5)
    Ht = jnp.asarray(h.reshape(T, C), jnp.float32)  # Ht[t, p] = h[t*C + p]
    htail = (T - 1) * C + C - 1
    state = ChannelizerState(
        tail=(jnp.zeros((htail, 2), jnp.int16) if input_format == "i16"
              # 127 ~ zero signal to within half an LSB
              else jnp.full((htail, 2), 127, jnp.uint8)
              if input_format == "u8"
              else jnp.zeros((htail,), jnp.complex64)))
    return Ht, state


def _branch_accumulate_conv(Ht, V, M: int, os: int):
    """One-pass PFB branch accumulation as a depthwise dilated conv.

    The default ('shift') engine accumulates T shifted elementwise
    multiply-adds over the (M_all, C) frame matrix — T reads of the full
    frame matrix from HBM unless XLA fuses them. This engine expresses
    the same sum as ONE depthwise convolution along the frame axis
    (feature_group_count=C, window T, rhs_dilation=os for the
    oversampled hop), so the input streams through once:

        u[m, p] = sum_k K[k, p] * V[m + os*k, p],   K[k, p] = Ht[T-1-k, p]

    V: (M_all, C) float32/complex64 (complex decomposes into two real
    convs host-side of the FFT). Returns (M, C) matching V's dtype."""
    T, C = Ht.shape
    K = Ht[::-1, :].reshape(T, 1, C)                    # (W, I=1, O=C)
    dn = lax.conv_dimension_numbers(
        (1, V.shape[0], C), (T, 1, C), ("NWC", "WIO", "NWC"))

    def real_conv(lhs):
        out = lax.conv_general_dilated(
            lhs[None, :, :], K, window_strides=(1,), padding="VALID",
            rhs_dilation=(os,), dimension_numbers=dn,
            feature_group_count=C, preferred_element_type=jnp.float32,
            precision=kp.MATMUL)
        return out[0]

    if jnp.iscomplexobj(V):
        return (real_conv(V.real.astype(jnp.float32))
                + 1j * real_conv(V.imag.astype(jnp.float32))
                ).astype(jnp.complex64)[:M]
    return real_conv(V.astype(jnp.float32))[:M]


def channelize(Ht, state: ChannelizerState, x, os: int = 1,
               engine: str = "shift"):
    """x: (N,) complex64 with N a multiple of C. Returns
    (state, Y (M, C) complex64): M = os*N/C frames of C channel samples;
    channel c is the signal at center +c/C cycles/sample, at unity
    prototype-passband gain.

    Derivation (hop R = C/os): Y[m, c] = sum_n x[n] e^{-2 pi j c n / C}
    h[mR - n] (mix-down then filter, sampled every R). With n = mR -
    (tC + p):
        Y[m, c] = e^{-2 pi j c mR/C} sum_p e^{+2 pi j c p / C}
                      sum_t h[tC+p] x[(m - os*t)R - p]
    i.e. branch p reads the commutator BACKWARDS: v[m, p] = x[mR - p],
    which is the column-reversed hop-R framing of the stream delayed by
    C-1, then T shifted (by os*t) multiply-adds and a C-point IFFT (x C)
    along p. Critically sampled (os=1) the leading phase term is 1; at
    os=2 it is (-1)^{c m} -- a parity sign flip on odd frames, applied
    after the IFFT. Block lengths a multiple of C keep M even, so the
    frame parity needs no carried state."""
    T, C = Ht.shape
    R = C // os
    n = x.shape[0]
    M = n // R
    xfull = jnp.concatenate([state.tail, x])  # ((T-1)*C + C-1 + N,)
    M_all = M + os * (T - 1)
    if os == 1:
        V = xfull[: M_all * C].reshape(M_all, C)[:, ::-1]
    else:
        B = xfull[: (M_all + 1) * R].reshape(M_all + 1, R)
        V = jnp.concatenate([B[:-1], B[1:]], axis=1)[:, ::-1]
    if engine == "conv":
        u = _branch_accumulate_conv(Ht, V, M, os)
    else:
        u = jnp.zeros((M, C), jnp.complex64)
        for t in range(T):
            u = u + Ht[t][None, :] * jax.lax.dynamic_slice_in_dim(
                V, os * (T - 1 - t), M, axis=0)
    Y = (jnp.fft.ifft(u, axis=1) * C).astype(jnp.complex64)
    if os == 2:
        sign_c = (1.0 - 2.0 * (jnp.arange(C) % 2)).astype(jnp.float32)
        odd = (jnp.arange(M) % 2).astype(jnp.float32)[:, None]
        Y = Y * ((1.0 - odd) + odd * sign_c[None, :])
    new_state = ChannelizerState(tail=xfull[-((T - 1) * C + C - 1):])
    return new_state, Y


def channelize_i16(Ht, state: ChannelizerState, x2, os: int = 1,
                   engine: str = "shift"):
    """channelize() for RAW wire-format input: x2 (N, 2) [re, im] as
    int16 (Ht carrying the 1/32767 scale, build(input_format='i16')) or
    RTL-SDR uint8 (Ht carrying 1/127.5, build(input_format='u8') — the
    -127.5 offset is a per-branch constant 127.5*sum_t Ht[t, p],
    subtracted from both components before the channel IFFT). The
    commutator framing stays at wire width (layout ops) and the
    per-branch multiply-accumulate converts components at the FMA
    operand, so the T passes over the frames read 1-2 B/component
    instead of 8 B/sample."""
    T, C = Ht.shape
    R = C // os
    n = x2.shape[0]
    M = n // R
    xfull = jnp.concatenate([state.tail, x2])            # (htail+N, 2)
    M_all = M + os * (T - 1)
    if os == 1:
        V = xfull[: M_all * C].reshape(M_all, C, 2)[:, ::-1]
    else:
        B = xfull[: (M_all + 1) * R].reshape(M_all + 1, R, 2)
        V = jnp.concatenate([B[:-1], B[1:]], axis=1)[:, ::-1]
    if engine == "conv":
        ur = _branch_accumulate_conv(Ht, V[..., 0], M, os)
        ui = _branch_accumulate_conv(Ht, V[..., 1], M, os)
    else:
        ur = jnp.zeros((M, C), jnp.float32)
        ui = jnp.zeros((M, C), jnp.float32)
        for t in range(T):
            sl = jax.lax.dynamic_slice_in_dim(V, os * (T - 1 - t), M, axis=0)
            ur = ur + Ht[t][None, :] * sl[..., 0].astype(jnp.float32)
            ui = ui + Ht[t][None, :] * sl[..., 1].astype(jnp.float32)
    if x2.dtype == jnp.uint8:
        dc = jnp.float32(127.5) * jnp.sum(Ht, axis=0)    # (C,) per branch
        ur = ur - dc[None, :]
        ui = ui - dc[None, :]
    Y = (jnp.fft.ifft(ur + 1j * ui, axis=1) * C).astype(jnp.complex64)
    if os == 2:
        sign_c = (1.0 - 2.0 * (jnp.arange(C) % 2)).astype(jnp.float32)
        odd = (jnp.arange(M) % 2).astype(jnp.float32)[:, None]
        Y = Y * ((1.0 - odd) + odd * sign_c[None, :])
    new_state = ChannelizerState(tail=xfull[-((T - 1) * C + C - 1):])
    return new_state, Y


class Channelizer:
    """Stateful analysis channelizer over fixed-size blocks."""

    def __init__(self, cfg: ChannelizerConfig = ChannelizerConfig(),
                 block_len: int = 1 << 20):
        if block_len % cfg.nchan:
            raise ValueError("block_len must be a multiple of nchan")
        self.cfg = cfg
        self.block_len = block_len
        from ..utils.hostbuild import host_build
        self.Ht, self.state = host_build(build, cfg)
        self._run = jax.jit(partial(channelize, os=cfg.oversample,
                                    engine=cfg.engine))

    def __call__(self, iq):
        iq = jnp.asarray(iq, jnp.complex64)
        self.state, Y = self._run(self.Ht, self.state, iq)
        return Y


class DemodBankState(NamedTuple):
    ch: ChannelizerState
    fd_prev: jnp.ndarray   # (C,) complex64
    deemph: jnp.ndarray    # (C,) float32
    front: object = None   # kab.FrontState (C,) when cfg.am_coherent
    dc: object = None      # (C,) f32 DC-tracker carry (coherent AM)


@dataclass(frozen=True)
class ChannelizedBankConfig:
    channelizer: ChannelizerConfig = ChannelizerConfig()
    # 'fm' | 'am' uniform, or a per-channel tuple of them (the reference
    # composes any demod per radio instance, wrapper.cpp:189-199; the EP
    # dispatch is branch-free: mask-select over batched bases, with the
    # coherent back end gathered onto its static AM subgroup)
    demod: object = "fm"
    kd: float = 0.3125     # at the channel rate (see chains/bank.py)
    deemph_tau: float = 75e-6
    # Full coherent back end for demod='am' (per-channel AGC + carrier
    # PLL + DC tracker, chains/bank.py's scheme) instead of raw envelope
    am_coherent: bool = False
    agc_bandwidth: float = 0.01
    agc_scale: float = 1.0
    modulation: float = 1.0

    def __post_init__(self):
        if isinstance(self.demod, str):
            if self.demod not in ("fm", "am"):
                raise ValueError(
                    f"unknown demod {self.demod!r} (use 'fm' or 'am')")
        else:
            d = tuple(self.demod)
            object.__setattr__(self, "demod", d)
            if len(d) != self.channelizer.nchan:
                raise ValueError(
                    f"demod tuple length {len(d)} != nchan "
                    f"{self.channelizer.nchan}")
            bad = sorted({x for x in d if x not in ("fm", "am")})
            if bad:
                raise ValueError(f"unknown demod(s) {bad} (use 'fm'/'am')")


def _demod_tuple(cfg: ChannelizedBankConfig):
    d = cfg.demod
    return (d,) * cfg.channelizer.nchan if isinstance(d, str) else d


def _am_indices(cfg: ChannelizedBankConfig):
    return tuple(i for i, d in enumerate(_demod_tuple(cfg)) if d == "am")


def _is_mixed(cfg: ChannelizedBankConfig):
    d = _demod_tuple(cfg)
    return any(x != d[0] for x in d)


def bank_build(cfg: ChannelizedBankConfig, input_format: str = "c64"):
    Ht, ch_state = build(cfg.channelizer, input_format)
    C = cfg.channelizer.nchan
    b0, a = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate, cfg.deemph_tau)
    front = dc0 = amb = None
    demods = _demod_tuple(cfg)
    am_idx = _am_indices(cfg)
    fm_mask = (None if not _is_mixed(cfg)
               else jnp.asarray([d == "fm" for d in demods]))
    if am_idx and cfg.am_coherent:
        Ca = len(am_idx)
        amb = kab.make_params(
            kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale),
            cfg.modulation, b0, a, carrier=True)
        front = kab.FrontState(
            agc=jax.tree.map(lambda v: jnp.broadcast_to(v, (Ca,)),
                             kagc.agc_init()),
            pll=PllState(jnp.zeros((Ca,), jnp.float32),
                         jnp.zeros((Ca,), jnp.float32)))
        dc0 = jnp.zeros((Ca,), jnp.float32)
    params = (Ht, jnp.float32(b0), jnp.float32(a), amb, fm_mask)
    state = DemodBankState(
        ch=ch_state,
        fd_prev=jnp.full((C,), 1.0 + 0.0j, jnp.complex64),
        deemph=jnp.zeros((C,), jnp.float32),
        front=front, dc=dc0,
    )
    return params, state


def bank_step(params, state: DemodBankState, x, *, cfg: ChannelizedBankConfig,
              backend: str = "xla"):
    """100 Msps IQ block -> (state, audio (C, M)): channelize then demod
    every channel (freqdem + de-emphasis for FM; envelope or the coherent
    AGC+PLL+DC back end for AM)."""
    Ht, b0, a, amb, fm_mask = params
    ch_fn = channelize_i16 if state.ch.tail.ndim == 2 else channelize
    ch_state, Y = ch_fn(Ht, state.ch, x, os=cfg.channelizer.oversample,
                        engine=cfg.channelizer.engine)  # (M, C)
    mixed0 = _is_mixed(cfg)
    if not mixed0 and _demod_tuple(cfg)[0] == "fm":
        # Row-major fast path for the uniform-FM bank (the bench-4
        # config): discriminator + de-emphasis run directly on the
        # channelizer's (M, C) frames — transposing the c64 frames first
        # costs more than the whole back end (the fused (C, M) transpose
        # measured ~97 ms of a 155 ms step at M=2048, C=1024 on CPU vs
        # ~25 ms for this path; only the final f32 audio transposes).
        prev = jnp.concatenate([state.fd_prev[None, :], Y[:-1]], axis=0)
        d = Y * jnp.conj(prev)
        base_mc = patan2(d.imag, d.real) / jnp.float32(TWO_PI * cfg.kd)
        b0_de, a_de = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate,
                                               cfg.deemph_tau)
        deemph, audio_mc = kiir.first_order_apply_blocked_mc(
            b0_de, a_de, state.deemph, base_mc)
        metrics = BlockMetrics(rssi=None, squelch_modes=None,
                               pll_freq=None, resamp_credit=None)
        return (DemodBankState(ch_state, Y[-1, :], deemph, state.front,
                               state.dc), (audio_mc.T, metrics))
    Yc = Y.T                                       # (C, M)
    front, dc = state.front, state.dc
    sq_modes = None
    mixed = _is_mixed(cfg)
    am_idx = _am_indices(cfg)

    def fm_base(y):
        xprev = jnp.concatenate([state.fd_prev[:, None], y[:, :-1]], axis=1)
        d = y * jnp.conj(xprev)
        return patan2(d.imag, d.real) / jnp.float32(
            TWO_PI * cfg.kd)

    def coherent(y, front0, dc0):
        # warmup derived from the live loop bandwidths (kernels/warmup.py)
        w = kwarm.warmup_for(agc_alpha=cfg.agc_bandwidth,
                             pll_bw=kab.PLL_BW)
        if backend == "pallas":
            from ..pallas.am_backend_scan import front_chunked_pallas
            fr, (vr, modes) = front_chunked_pallas(
                amb, front0, y, chunk=kwarm.chunk_for(w), warmup=w)
        else:
            fr, (vr, modes) = jax.vmap(
                lambda s, xs: kab.front_chunked(
                    amb, s, xs, chunk=kwarm.chunk_for(w), warmup=w)
            )(front0, y)
        # matmul-blocked scan for the rho=0.9995 DC pole (110.6 dB vs
        # f64 serial; FIDELITY.md)
        dc2, dct = jax.vmap(
            lambda d0, v: kiir.first_order_apply_blocked(
                1.0 - kam.DC_RHO, kam.DC_RHO, d0, v))(dc0, vr)
        return fr, dc2, (vr - dct) * amb.inv_mod, modes

    if not mixed and _demod_tuple(cfg)[0] == "fm":
        base = fm_base(Yc)
    elif not mixed and cfg.am_coherent:
        front, dc, base, sq_modes = coherent(Yc, state.front, state.dc)
    elif not mixed:
        base = jnp.abs(Yc).astype(jnp.float32)
    else:
        # mixed fm/am bank: branch-free mask select (EP); the coherent
        # back end gathers its static AM subgroup and scatters back
        base = jnp.where(fm_mask[:, None], fm_base(Yc),
                         jnp.abs(Yc).astype(jnp.float32))
        if cfg.am_coherent and am_idx:
            idx = jnp.asarray(am_idx)
            front, dc, coh, sq_modes = coherent(Yc[idx, :], state.front,
                                                state.dc)
            base = base.at[idx].set(coh)
    fd_prev = Yc[:, -1]
    # matmul-blocked de-emphasis (coefficients re-derived at trace time;
    # cfg is static -- the params copies stay for compat)
    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.channelizer.chan_rate,
                                           cfg.deemph_tau)
    deemph, audio = jax.vmap(
        lambda y0, xs: kiir.first_order_apply_blocked(b0_de, a_de, y0, xs)
    )(state.deemph, base)
    metrics = BlockMetrics(
        rssi=None if front is None else kmet.rssi_db(front.agc.g),
        squelch_modes=sq_modes,
        pll_freq=None if front is None else front.pll.freq,
        resamp_credit=None,
    )
    return DemodBankState(ch_state, fd_prev, deemph, front, dc), (audio,
                                                                  metrics)


class ChannelizedBank:
    """After each call, ``self.metrics`` holds the block's BlockMetrics."""

    def __init__(self, cfg: ChannelizedBankConfig = ChannelizedBankConfig(),
                 block_len: int = 1 << 20, backend: str = "xla",
                 input_format: str = "c64"):
        if block_len % cfg.channelizer.nchan:
            raise ValueError("block_len must be a multiple of nchan")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {backend!r} (use 'xla' or 'pallas')")
        self.cfg = cfg
        self.block_len = block_len
        self.input_format = input_format
        from ..utils.hostbuild import host_build
        self.params, self.state = host_build(bank_build, cfg, input_format)
        self.metrics = None
        self._step = jax.jit(partial(bank_step, cfg=cfg, backend=backend))

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
        with annotate("ChannelizedBank.step"):
            self.state, (audio, metrics) = self._step(self.params, self.state,
                                                      iq)
        self.metrics = metrics
        return audio
