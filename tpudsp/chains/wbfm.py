"""WBFM broadcast receiver chain (BASELINE.json config 2):
2.4 Msps IQ -> channel filter + decimate -> FM discriminator -> audio
decimate -> de-emphasis -> 48 kHz PCM (mono), or -> FMStereo composite
decoding (stereo).

Implemented as a single-channel ReceiverBank (chains/bank.py) for mono --
the whole front end is two batched strided convolutions -- plus a stereo
variant that runs the discriminator at the intermediate rate and feeds the
block-parallel pilot-squaring stereo decoder (tpudsp/kernels/pll.py).
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
from ..kernels import freqdem as kfd
from ..kernels import iir as kiir
from ..kernels import precision as kp
from ..kernels import pll as kpll
from ..kernels import nco as knco
from .bank import BankConfig, ReceiverBank
from .metrics import BlockMetrics

TWO_PI = 2.0 * np.pi


def mono_receiver(freq_offset_hz: float = 0.0, iq_rate: float = 2_400_000.0,
                  block_len: int = 1_000_000) -> ReceiverBank:
    """Mono WBFM: decimate 2.4M -> 240k, freqdem, decimate -> 48k, deemph."""
    chan_rate = iq_rate / 10
    cfg = BankConfig(freqs=(freq_offset_hz,), iq_rate=iq_rate, demod="fm",
                     decim1=10, decim2=5, kd=75_000.0 / chan_rate)
    return ReceiverBank(cfg, block_len=block_len)


class StereoState(NamedTuple):
    in_tail: jnp.ndarray
    fd_prev: jnp.ndarray
    pilot: kpll.StereoPilotState
    aud_tail: jnp.ndarray
    dl: jnp.ndarray
    dr: jnp.ndarray
    a_tail_l: jnp.ndarray
    a_tail_r: jnp.ndarray


@dataclass(frozen=True)
class StereoConfig:
    iq_rate: float = 2_400_000.0
    decim1: int = 4     # 2.4M -> 600k composite rate (fits 19/38/53 kHz)
    decim2: int = 25    # audio rate = 2*comp_rate/decim2 (600k -> 48k): the
                        # fractional 12.5x decimation runs as two strided-by-
                        # decim2 convolutions offset by decim2/2 samples
    taps1: int = 96
    taps2: int = 256
    kd: float = 4.0


def _stereo_step(params, state: StereoState, iq, *, cfg: StereoConfig):
    """Returns (state, (pcm (M, 2) float32 on device, BlockMetrics)):
    pilot_level/pll_freq carry the 19 kHz stereo-lock telemetry."""
    D1 = cfg.decim1
    h1, h2, h_aud, dtheta_u, b0, a = params
    X = jnp.concatenate([state.in_tail, iq])
    # decimate to composite rate with a real lowpass (conv over re/im).
    # Raw wire-format blocks ((N, 2) int16/uint8, h1 carrying the folded
    # wire scale -- build(input_format=...)) convert at the conv operand;
    # the u8 -127.5 offset is subtracted up front (a DC in I/Q would
    # land a spur at 0 Hz in the discriminator), fused by XLA into the
    # conv's im2col read. HBM ingest: 2-4 B/sample instead of 8.
    if X.ndim == 2:
        feats = jnp.stack([X[:, 0], X[:, 1]]).astype(jnp.float32)
        if X.dtype == jnp.uint8:
            feats = feats - jnp.float32(127.5)
    else:
        feats = jnp.stack([X.real, X.imag]).astype(jnp.float32)
    y = lax.conv_general_dilated(feats[None], h1, (D1,), "VALID",
                                 precision=kp.MATMUL)[0]
    comp_iq = (y[0] + 1j * y[1]).astype(jnp.complex64)
    fd_prev, s = kfd.freqdem_apply(jnp.float32(cfg.kd), state.fd_prev, comp_iq)
    pilot, lr, (pilot_level, pilot_freq) = kpll.stereo_pilot_apply(
        state.pilot, s, dtheta_u, with_metrics=True)
    aud_tail, (left, right) = kpll.stereo_matrix_lowpass(h_aud, state.aud_tail, s, lr)
    # matmul-blocked de-emphasis at the composite rate (coefficients
    # re-derived at trace time; cfg is static -- params copies stay for
    # compat)
    b0_de, a_de = iirdes.deemphasis_coeffs(cfg.iq_rate / cfg.decim1)
    dl, left = kiir.first_order_apply_blocked(b0_de, a_de, state.dl, left)
    dr, right = kiir.first_order_apply_blocked(b0_de, a_de, state.dr, right)
    # audio decimation 600k -> 48k (rate 2/decim2 = 2/25): interleaved
    # output k sits at composite position k*decim2/2, i.e. even outputs at
    # 25j (phase-0 taps, window start 0) and odd outputs at 25j + 12.5
    # (half-sample-offset taps, window start shifted by decim2//2)
    D2 = cfg.decim2
    half = D2 // 2
    def dec_audio(tail, xs):
        A = jnp.concatenate([tail, xs])
        o0 = lax.conv_general_dilated(A[None, None], h2[0][None, None], (D2,),
                                      "VALID", precision=kp.MATMUL)[0, 0]
        o1 = lax.conv_general_dilated(A[None, None, half:], h2[1][None, None],
                                      (D2,), "VALID",
                                      precision=kp.MATMUL)[0, 0]
        n = min(o0.shape[0], o1.shape[0])
        out = jnp.stack([o0[:n], o1[:n]], 1).reshape(-1)
        return A[-(h2.shape[1] - 1):], out

    a_tail_l, pl_ = dec_audio(state.a_tail_l, left)
    a_tail_r, pr_ = dec_audio(state.a_tail_r, right)
    new_state = StereoState(X[-(state.in_tail.shape[0]):], fd_prev, pilot,
                            aud_tail, dl, dr, a_tail_l, a_tail_r)
    pcm = jnp.stack([pl_, pr_], axis=1)  # (M, 2), stacked in-jit
    metrics = BlockMetrics(rssi=None, squelch_modes=None,
                           pll_freq=pilot_freq, resamp_credit=None,
                           pilot_level=pilot_level)
    return new_state, (pcm, metrics)


class WBFMStereoReceiver:
    """Stereo WBFM at 2.4 Msps: decimate to a 600 ksps composite, FM
    discriminator, pilot-squaring stereo decode, de-emphasis, and a
    two-phase polyphase decimation 600k -> 48k (rate 2/25: two strided
    convolutions with half-sample-offset taps)."""

    def __init__(self, cfg: StereoConfig = StereoConfig(),
                 block_len: int = 1_000_000, input_format: str = "c64"):
        if block_len % (cfg.decim1 * cfg.decim2):
            raise ValueError("block_len must be a multiple of decim1*decim2")
        if input_format not in ("c64", "i16", "u8"):
            raise ValueError(f"unknown input_format {input_format!r} "
                             "(use 'c64', 'i16' or 'u8')")
        self.cfg = cfg
        self.input_format = input_format
        comp_rate = cfg.iq_rate / cfg.decim1       # 600 k
        h1 = firdes.kaiser_lowpass(cfg.taps1, 0.45 / cfg.decim1, 60.0)[::-1]
        # wire-format ingest: the int->float scale folds into the channel
        # lowpass (same scheme as chains/bank.py build(input_format=...))
        h1 = h1 * {"c64": 1.0, "i16": 1.0 / 32767.0,
                   "u8": 1.0 / 127.5}[input_format]
        h1 = np.stack([np.stack([h1, np.zeros_like(h1)]),
                       np.stack([np.zeros_like(h1), h1])]).astype(np.float32)
        # audio decimation taps: prototype at composite rate, cutoff 21.6 kHz;
        # two polyphase rows for output positions k*25/2 (even k: offset 0,
        # odd k: offset 12.5 -> taps sampled at half-integer offsets)
        L = cfg.taps2
        proto = firdes.kaiser_lowpass(L, 21600.0 / comp_rate, 60.0)
        proto_half = firdes.kaiser_lowpass(L, 21600.0 / comp_rate, 60.0, mu=0.5)
        h2 = np.stack([proto[::-1], proto_half[::-1]]).astype(np.float32)
        b0, aa = iirdes.deemphasis_coeffs(comp_rate)
        dtheta = knco.rad_to_u32(TWO_PI * 19000.0 / comp_rate)
        h_aud = firdes.stereo_audio_lowpass(comp_rate)
        from ..utils.hostbuild import host_build

        def _design():
            params = (jnp.asarray(h1), jnp.asarray(h2),
                      jnp.asarray(h_aud, jnp.float32),
                      jnp.uint32(dtheta), jnp.float32(b0), jnp.float32(aa))
            in_tail = (
                jnp.zeros((cfg.taps1 - 1, 2), jnp.int16)
                if input_format == "i16"
                # 127 ~ zero signal to within half an LSB
                else jnp.full((cfg.taps1 - 1, 2), 127, jnp.uint8)
                if input_format == "u8"
                else jnp.zeros((cfg.taps1 - 1,), jnp.complex64))
            state = StereoState(
                in_tail=in_tail,
                fd_prev=jnp.complex64(1.0),
                pilot=kpll.stereo_pilot_init(),
                aud_tail=jnp.zeros((len(h_aud) - 1,), jnp.complex64),
                dl=jnp.float32(0.0), dr=jnp.float32(0.0),
                a_tail_l=jnp.zeros((cfg.taps2 - 1,), jnp.float32),
                a_tail_r=jnp.zeros((cfg.taps2 - 1,), jnp.float32),
            )
            return params, state

        self._params, self.state = host_build(_design)
        self.block_len = block_len
        self.metrics = None
        self._step = jax.jit(partial(_stereo_step, cfg=cfg))

    def __call__(self, iq):
        """Returns (M, 2) float32 PCM ON DEVICE (no host sync: StreamRuntime
        overlap depends on the step only enqueueing device work); sets
        ``self.metrics`` (pilot_level, pll_freq) for the block."""
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
        self.state, (pcm, metrics) = self._step(self._params, self.state, iq)
        self.metrics = metrics
        return pcm
