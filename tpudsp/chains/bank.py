"""Multi-channel receiver bank (BASELINE.json configs 3-5).

A shared wideband IQ stream feeds C independent receiver chains
(per-channel NCO mix -> decimating channel filter -> demod -> audio).
This is the DSP analog of data parallelism (SURVEY.md section 2.3): zero
inter-channel communication, so channels batch on one chip and shard over
the ``channel`` mesh axis.

Structure -- the whole front end is TWO batched strided convolutions
(matmuls):

  - The per-channel mix-down folds into the channel filter:
      conv(x * e^{-j w_c n}, h)[m] = e^{-j w_c m D} * conv(x, h * e^{+j w_c k})[m]
    so one conv with per-channel *modulated taps* (C output features)
    replaces C separate mix+filter chains; a closed-form phasor applies the
    output rotation. No per-channel data blowup at the input rate.
  - Complex-input/complex-taps convolution decomposes into 2 real convs
    with stacked (re, im) input features.

The back end (freqdem -> audio decimation -> de-emphasis, or AGC+envelope
for AM channels) runs at the decimated rate, vmapped over channels;
recurrences are associative scans (first-order) -- nothing sequential
remains at the input rate.
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
from ..kernels import decimate as kdec
from ..kernels import freqdem as kfd
from ..kernels import iir as kiir
from ..kernels import precision as kp
from ..kernels import warmup as kwarm
from ..kernels.pll import PllState
from . import metrics as kmet
from .metrics import BlockMetrics

TWO_PI = 2.0 * np.pi


def _demod_tuple(cfg) -> tuple:
    """Static per-channel demod types from cfg.demod (str or tuple)."""
    if isinstance(cfg.demod, str):
        return (cfg.demod,) * cfg.nchan
    return tuple(cfg.demod)


def _am_indices(cfg) -> tuple:
    return tuple(i for i, d in enumerate(_demod_tuple(cfg)) if d == "am")


@dataclass(frozen=True)
class BankConfig:
    freqs: tuple          # per-channel center freqs in Hz
    iq_rate: float = 2_400_000.0
    # 'fm' (freqdem+deemph), 'am' (envelope, or the coherent back end with
    # am_coherent), 'usb'/'lsb' (single sideband: the complex baseband is
    # decimated through a shared one-sided/analytic audio filter h2s and
    # Re taken -- sideband selection at the channel rate, where the
    # transition band is sharp enough for a one-sided edge at the
    # carrier; lsb conjugates the baseband to reuse the usb taps), or a
    # per-channel tuple of those -- the EP-analog dispatch of SURVEY.md
    # section 2.3: demod type selects a kernel per channel, executed
    # branch-free as batched compute + mask select (no gather/scatter,
    # no divergence).
    demod: str | tuple = "fm"
    decim1: int = 10      # input rate -> channel rate
    decim2: int = 5       # channel rate -> audio rate
    # FM demod factor normalized at the CHANNEL (decimated) rate: for a
    # peak deviation of `dev` Hz, kd = dev/chan_rate recovers the message
    # at unit gain; the discriminator needs chan_rate > 2*(dev + f_audio)
    # so per-sample phase steps stay below pi (no wrapping).
    kd: float = 0.3125
    taps1: int = 128      # channel filter length
    taps2: int = 64       # audio filter length
    # SSB sideband-split filter length (at the channel rate). The split
    # quality is set by this filter's transition width ~ (As-8)/(14.36 N)
    # cycles: 512 taps at a 240 kHz channel rate give a ~1.7 kHz
    # transition centered on the carrier (full stopband rejection beyond
    # ~850 Hz into the wrong sideband); raise it for 300 Hz-grade voice
    # edges. Cost is one blocked matmul at the channel rate.
    taps2_ssb: int = 512
    # Full coherent back end for the AM channels (AGC gain loop -> carrier
    # PLL -> DC tracker, the single-channel chain's kernels/am_backend.py)
    # instead of the bare envelope |y1|: batched over the AM channels via
    # the warmup-chunk scans (XLA vmap or the fused Pallas kernel,
    # ReceiverBank(backend=...)). Envelope stays the default: it is exact,
    # memoryless, and right for strong-signal broadcast scanning.
    am_coherent: bool = False
    agc_bandwidth: float = 0.01   # AGC loop bw at the channel rate
    agc_scale: float = 1.0        # post-AGC output scale
    modulation: float = 1.0       # AM modulation index (audio = vr/mod)
    # Squelch gating in the coherent-AM channels' AGC (reference
    # agc.hpp:109-128): gated channels emit zeroed audio; the per-channel
    # per-sample FSM tensor lands in BlockMetrics.squelch_modes for
    # host-side event delivery (squelch_events / StreamRuntime on_event).
    squelch: bool = False
    squelch_threshold: float = 0.0  # dB at the channel rate
    squelch_timeout: int = 100

    @property
    def nchan(self):
        return len(self.freqs)

    @property
    def chan_rate(self):
        return self.iq_rate / self.decim1

    @property
    def audio_rate(self):
        return self.chan_rate / self.decim2


class BankParams(NamedTuple):
    taps_re: jnp.ndarray     # (C, Kc, D1): blocked modulated channel taps (re)
    taps_im: jnp.ndarray     # (C, Kc, D1): (im); correlation order
    dtheta: jnp.ndarray      # (C,) uint32 per-sample phase increments
    h2: jnp.ndarray          # (Kc2, D2) blocked audio decimation taps (shared)
    deemph_b0: jnp.ndarray
    deemph_a: jnp.ndarray
    fm_mask: jnp.ndarray     # (C,) bool: per-channel FM discriminator
    amb: object = None       # AmBackendParams when cfg.am_coherent
    ssb_mask: object = None  # (C,) bool: per-channel SSB channels
    h2s_re: object = None    # (Kc2, D2) one-sided audio taps (re), shared
    h2s_im: object = None    # (Kc2, D2) one-sided audio taps (im), shared
    lsb_sign: object = None  # (C,) f32: -1 for lsb channels (conj), +1 else


class BankState(NamedTuple):
    in_tail: jnp.ndarray     # (K1-1,) complex64 shared input tail
    phase: jnp.ndarray       # (C,) uint32 NCO phases at block start (output rate ref)
    n0: jnp.ndarray          # uint32 global sample index of block start
    fd_prev: jnp.ndarray     # (C,) complex64 freqdem carry
    a_tail: jnp.ndarray      # (C, K2-1) float32 audio filter tails
    deemph: jnp.ndarray      # (C,) float32 de-emphasis carry
    front: object = None     # FrontState (Ca,) for the coherent AM channels
    dc: object = None        # (Ca,) f32 DC-tracker carry (coherent AM)
    y1_tail: object = None   # (C, K2-1) complex64 baseband tails (SSB banks)


def build(cfg: BankConfig, input_format: str = "c64"):
    """input_format='i16' plans for RAW interleaved int16 IQ: the 1/32767
    scale folds into the modulated channel taps and the shared input tail
    stays int16 (4 B/sample HBM ingest instead of 8). input_format='u8'
    is the RTL-SDR wire format ((b-127.5)/127.5, 2 B/sample): the 1/127.5
    scale folds the same way and the offset becomes a per-channel DC term
    inside the front-end matmul (kernels/decimate.py
    strided_cfir_matmul_wide_u8)."""
    if input_format not in ("c64", "i16", "u8"):
        raise ValueError(f"unknown input_format {input_format!r} "
                         "(use 'c64', 'i16' or 'u8')")
    C = cfg.nchan
    if not isinstance(cfg.demod, str) and len(cfg.demod) != C:
        raise ValueError("per-channel demod tuple must match freqs")
    demods = _demod_tuple(cfg)
    bad = [d for d in demods if d not in ("fm", "am", "usb", "lsb")]
    if bad:
        raise ValueError(
            f"unknown demod type(s) {bad!r} (use 'fm'/'am'/'usb'/'lsb')")
    k = np.arange(cfg.taps1)
    # channel filter: full-width lowpass at the input rate (SSB sideband
    # selection happens at the CHANNEL rate, where the filter transition
    # is sharp enough for a one-sided edge at the carrier -- see h2s)
    h1 = firdes.kaiser_lowpass(cfg.taps1, 0.45 / cfg.decim1, 60.0)
    w = np.array([TWO_PI * f / cfg.iq_rate for f in cfg.freqs])  # rad/sample
    # modulated taps h1[k] e^{+j w_c k}, flipped to correlation order and
    # D1-blocked for the matmul front end (kernels/decimate.py)
    hm = (h1[None, :] * np.exp(1j * w[:, None] * k[None, :]))[:, ::-1]
    if input_format == "i16":
        hm = hm * (1.0 / 32767.0)
    elif input_format == "u8":
        hm = hm * (1.0 / 127.5)
    taps_re = kdec.plan_phase_taps(hm.real.astype(np.float32), cfg.decim1)
    taps_im = kdec.plan_phase_taps(hm.imag.astype(np.float32), cfg.decim1)
    h2p = firdes.kaiser_lowpass(cfg.taps2, 0.45 / cfg.decim2, 60.0)[::-1]
    h2 = kdec.plan_phase_taps(h2p[None, :].astype(np.float32), cfg.decim2)[0]
    b0, a = iirdes.deemphasis_coeffs(cfg.audio_rate)
    fm_mask = np.array([d == "fm" for d in demods])
    ssb_mask = np.array([d in ("usb", "lsb") for d in demods])
    lsb_mask = np.array([d == "lsb" for d in demods])
    # SSB audio decimator: HALF-width lowpass shifted to [0, 0.45/D2]
    # cycles at the channel rate -- a one-sided (analytic) filter whose
    # lower edge sits at the carrier. USB audio = 2 Re(decim(y1, h2s));
    # LSB mirrors by conjugating the baseband instead of the taps, so one
    # shared tap set serves both (lsb_sign flips the imaginary part).
    # The factor 2 restores unit message gain: a one-sided filter keeps
    # only the analytic half of the real message's spectrum. Split
    # sharpness comes from taps2_ssb (see BankConfig).
    h2s_re = h2s_im = lsb_sign = None
    if ssb_mask.any():
        fsh2 = 0.225 / cfg.decim2
        k2 = np.arange(cfg.taps2_ssb)
        hs = 2.0 * (firdes.kaiser_lowpass(cfg.taps2_ssb, fsh2, 60.0)
                    * np.exp(2j * np.pi * fsh2 * k2))[::-1]
        h2s_re = kdec.plan_phase_taps(hs.real[None, :].astype(np.float32),
                                      cfg.decim2)[0]
        h2s_im = kdec.plan_phase_taps(hs.imag[None, :].astype(np.float32),
                                      cfg.decim2)[0]
        lsb_sign = np.where(lsb_mask, -1.0, 1.0).astype(np.float32)
    dtheta = np.array(
        [np.uint32(int(round((wc % TWO_PI) / TWO_PI * 2**32)) & 0xFFFFFFFF) for wc in w],
        dtype=np.uint32)
    amb = front = dc0 = None
    am_idx = _am_indices(cfg)
    if cfg.am_coherent and am_idx:
        Ca = len(am_idx)
        amb = kab.make_params(
            kagc.make_params(alpha=cfg.agc_bandwidth, scale=cfg.agc_scale,
                             squelch=cfg.squelch,
                             threshold=cfg.squelch_threshold,
                             timeout=cfg.squelch_timeout),
            cfg.modulation, b0, a, carrier=True)
        front = kab.FrontState(
            agc=jax.tree.map(
                lambda v: jnp.broadcast_to(v, (Ca,)),
                kagc.agc_init(squelch=cfg.squelch,
                              timeout=cfg.squelch_timeout)),
            pll=PllState(jnp.zeros((Ca,), jnp.float32),
                         jnp.zeros((Ca,), jnp.float32)))
        dc0 = jnp.zeros((Ca,), jnp.float32)
    params = BankParams(
        taps_re=jnp.asarray(taps_re), taps_im=jnp.asarray(taps_im),
        dtheta=jnp.asarray(dtheta), h2=jnp.asarray(h2),
        deemph_b0=jnp.float32(b0), deemph_a=jnp.float32(a),
        fm_mask=jnp.asarray(fm_mask), amb=amb,
        ssb_mask=jnp.asarray(ssb_mask),
        h2s_re=None if h2s_re is None else jnp.asarray(h2s_re),
        h2s_im=None if h2s_im is None else jnp.asarray(h2s_im),
        lsb_sign=None if lsb_sign is None else jnp.asarray(lsb_sign),
    )
    state = BankState(
        in_tail=(jnp.zeros((cfg.taps1 - 1, 2), jnp.int16)
                 if input_format == "i16"
                 # 127 ~ zero signal to within half an LSB
                 else jnp.full((cfg.taps1 - 1, 2), 127, jnp.uint8)
                 if input_format == "u8"
                 else jnp.zeros((cfg.taps1 - 1,), jnp.complex64)),
        phase=jnp.zeros((C,), jnp.uint32),
        n0=jnp.uint32(0),
        fd_prev=jnp.full((C,), 1.0 + 0.0j, jnp.complex64),
        a_tail=jnp.zeros((C, cfg.taps2 - 1), jnp.float32),
        deemph=jnp.zeros((C,), jnp.float32),
        front=front, dc=dc0,
        y1_tail=None if not ssb_mask.any()
        else jnp.zeros((C, cfg.taps2_ssb - 1), jnp.complex64),
    )
    return params, state


def _fm_base(y1, fd_prev, kd):
    xprev = jnp.concatenate([fd_prev[:, None], y1[:, :-1]], axis=1)
    d = y1 * jnp.conj(xprev)
    return patan2(d.imag, d.real) / jnp.float32(
        TWO_PI * kd)


def _audio_decimate(A, h2, D2, nj):
    """Per-channel strided FIR with shared blocked taps h2 (Kc2, D2):
    A: (C, L) float32 -> (C, nj). Same blocked-matmul scheme as
    kernels/decimate.py, batched over channels."""
    C = A.shape[0]
    Kc2 = h2.shape[0]
    M = nj + Kc2 - 1
    Am = A[:, : M * D2].reshape(C, M, D2)
    Z = jnp.einsum("cmq,kq->cmk", Am, h2, preferred_element_type=jnp.float32,
                   precision=kp.MATMUL)
    acc = Z[:, 0:nj, 0]
    for kk in range(1, Kc2):
        acc = acc + Z[:, kk:kk + nj, kk]
    return acc


def bank_step(params: BankParams, state: BankState, iq, *, cfg: BankConfig,
              backend: str = "xla"):
    """iq: (N,) complex64 shared stream, N multiple of decim1*decim2.
    Returns (state, (audio (C, N/(decim1*decim2)) float32, BlockMetrics)).

    backend selects the engine for the coherent-AM feedback scans when
    cfg.am_coherent: 'xla' (vmapped warmup-chunk scans) or 'pallas' (the
    fused kernel, pallas/am_backend_scan.front_chunked_pallas)."""
    C = cfg.nchan
    D1, D2 = cfg.decim1, cfg.decim2
    K1, K2 = cfg.taps1, cfg.taps2
    n = iq.shape[0]
    X = jnp.concatenate([state.in_tail, iq])  # (K1-1+N,) or (.., 2) i16

    # batched mix+channelize -> (C, N/D1) complex; the engine resolves
    # per platform at trace time (the wide matmul on the GPU, XLA's
    # native strided conv on the CPU -- kernels/decimate.cfir_engine)
    nj1 = n // D1
    y1m = kdec.strided_cfir(X, params.taps_re, params.taps_im, D1, nj1)
    # output rotation: e^{-j w_c (n0 + m D1)} via uint32 phase lattice
    m = jnp.arange(nj1, dtype=jnp.uint32)
    th_u = (state.phase[:, None]
            + (state.n0 * params.dtheta)[:, None]
            + m[None, :] * (params.dtheta * jnp.uint32(D1))[:, None])
    theta = th_u.astype(jnp.float32) * jnp.float32(TWO_PI / 4294967296.0)
    rot = jnp.exp(-1j * theta)
    y1 = y1m * rot  # (C, N/D1) complex64 baseband per channel

    demods = _demod_tuple(cfg)
    ssb_any = any(d in ("usb", "lsb") for d in demods)
    all_ssb = all(d in ("usb", "lsb") for d in demods)
    if cfg.demod == "fm":
        base = _fm_base(y1, state.fd_prev, cfg.kd)
    elif cfg.demod == "am":
        base = jnp.abs(y1).astype(jnp.float32)
    elif isinstance(cfg.demod, str) and ssb_any:
        # real demod happens below through the one-sided h2s decimator;
        # the real-path base only maintains the (unused) a_tail carry
        base = y1.real.astype(jnp.float32)
    else:  # mixed bank: compute all batched, mask-select per channel
        base = jnp.where(params.fm_mask[:, None],
                         _fm_base(y1, state.fd_prev, cfg.kd),
                         jnp.where(params.ssb_mask[:, None],
                                   y1.real.astype(jnp.float32),
                                   jnp.abs(y1).astype(jnp.float32)))
    fd_prev = y1[:, -1]

    am_idx = _am_indices(cfg)
    front, dc = state.front, state.dc
    sq_modes = None
    if cfg.am_coherent and am_idx:
        # coherent AM channels: AGC gain loop + carrier PLL (batched
        # feedback scans) -> DC tracker (first-order assoc scan), all at
        # the channel rate, overwriting the envelope rows of `base`
        idx = jnp.asarray(am_idx)
        y_am = y1[idx, :]
        # warmup from the live loop bandwidths (kernels/warmup.py), never
        # a frozen constant
        w = kwarm.warmup_for(
            agc_alpha=cfg.agc_bandwidth, pll_bw=kam.PLL_BW,
            squelch_timeout=cfg.squelch_timeout if cfg.squelch else 0)
        if backend == "pallas":
            from ..pallas.am_backend_scan import front_chunked_pallas
            front, (vr, sq_modes) = front_chunked_pallas(
                params.amb, state.front, y_am, chunk=kwarm.chunk_for(w),
                warmup=w)
        else:
            front, (vr, sq_modes) = jax.vmap(
                lambda s, xs: kab.front_chunked(
                    params.amb, s, xs, chunk=kwarm.chunk_for(w), warmup=w)
            )(state.front, y_am)
        # rho = 0.9995 pole: matmul-blocked scan with double-float block
        # carry (plain f32 floors at ~86 dB, FIDELITY.md; blocked
        # measures 110.6 dB vs f64 serial)
        dc, dct = jax.vmap(
            lambda d0, v: kiir.first_order_apply_blocked(
                1.0 - kam.DC_RHO, kam.DC_RHO, d0, v)
        )(state.dc, vr)
        coh = (vr - dct) * params.amb.inv_mod
        if len(am_idx) == C:
            base = coh  # all-AM bank: no scatter, envelope is dead code
        else:
            base = base.at[idx].set(coh)

    # audio decimation: per-channel blocked matmul with shared taps
    nj2 = nj1 // D2
    A = jnp.concatenate([state.a_tail, base], axis=1)  # (C, K2-1+N/D1)
    audio = _audio_decimate(A, params.h2, D2, nj2)  # (C, N/(D1 D2))

    # SSB channels: decimate the COMPLEX baseband through the one-sided
    # (analytic) audio taps h2s and take Re -- true sideband selection at
    # the channel rate. LSB channels conjugate the baseband (lsb_sign
    # flips Im), mirroring the spectrum so the shared upper-sideband taps
    # serve both. Branch-free over all channels (the EP-analog idiom), so
    # the identical code shards over the channel axis.
    y1_tail = state.y1_tail
    if ssb_any:
        K2s = cfg.taps2_ssb
        Yf = jnp.concatenate([state.y1_tail, y1], axis=1)  # (C, K2s-1+N/D1)
        yi = Yf.imag * params.lsb_sign[:, None]
        audio_ssb = (_audio_decimate(Yf.real, params.h2s_re, D2, nj2)
                     - _audio_decimate(yi, params.h2s_im, D2, nj2))
        audio = audio_ssb if all_ssb else jnp.where(
            params.ssb_mask[:, None], audio_ssb, audio)
        y1_tail = Yf[:, -(K2s - 1):]

    # de-emphasis: matmul-blocked first-order scan vmapped over channels
    # (coefficients re-derived at trace time -- cfg is static)
    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.audio_rate)
    deemph, audio = jax.vmap(
        lambda y0, xs: kiir.first_order_apply_blocked(b0_de, a_de, y0, xs)
    )(state.deemph, audio)

    new_state = BankState(
        in_tail=X[-(K1 - 1):],
        phase=state.phase,
        n0=state.n0 + jnp.uint32(n),
        fd_prev=fd_prev,
        a_tail=A[:, -(K2 - 1):],
        deemph=deemph,
        front=front, dc=dc,
        y1_tail=y1_tail,
    )
    # per-block metrics (SURVEY section 5): the coherent AM channels carry
    # AGC rssi, the squelch-mode tensor and the recovered-carrier PLL
    # frequency; non-coherent banks report None fields
    metrics = BlockMetrics(
        rssi=None if front is None else kmet.rssi_db(front.agc.g),
        squelch_modes=sq_modes,
        pll_freq=None if front is None else front.pll.freq,
        resamp_credit=None,  # integer decimators: no fractional credit
    )
    return new_state, (audio, metrics)


class ReceiverBank:
    """Stateful multi-channel bank over fixed-size shared-IQ blocks.
    After each call, ``self.metrics`` holds the block's BlockMetrics."""

    def __init__(self, cfg: BankConfig, block_len: int = 1_000_000,
                 backend: str = "xla", input_format: str = "c64"):
        D = cfg.decim1 * cfg.decim2
        if block_len % D:
            raise ValueError(f"block_len must be a multiple of {D}")
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {backend!r} (use 'xla' or 'pallas')")
        self.cfg = cfg
        self.block_len = block_len
        self.input_format = input_format
        from ..utils.hostbuild import host_build
        self.params, self.state = host_build(build, cfg, input_format)
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
        with annotate("ReceiverBank.step"):
            self.state, (audio, metrics) = self._step(self.params, self.state, iq)
        self.metrics = metrics
        return audio
