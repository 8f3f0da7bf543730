"""Demodulator op classes (reference demod.hpp parity).

Mirrors: FreqDem, AmpModem, SSBDemod, FMStereo, BroadcastAM
(wrapper.cpp:183-199, 259-272).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..design import firdes, iirdes
from ..kernels import ampmodem as kam
from ..kernels import fir as kfir
from ..kernels import freqdem as kfd
from ..kernels import hilbert as khilb
from ..kernels import iir as kiir
from ..kernels import pll as kpll
from ..kernels import resamp as krs
from .base import StatefulOp, as_c64

_freqdem = jax.jit(kfd.freqdem_apply)
_c2r_apply = jax.jit(khilb.c2r_apply)


class FreqDem(StatefulOp):
    """FM demodulator (reference demod.hpp:189-219, wrapper.cpp:183-187):
    FreqDem(kd); y[n] = arg(conj(x[n-1]) x[n]) / (2 pi kd)."""

    def __init__(self, kd):
        self._kd = float(kd)
        self._state = kfd.freqdem_init()

    def reset(self):
        self._state = kfd.freqdem_init()

    def print(self):
        print(f"freqdem [kd: {self._kd:.4f}]")

    def __call__(self, inp):
        xj = as_c64(inp)
        self._state, y = _freqdem(jnp.float32(self._kd), self._state, xj)
        return np.asarray(y)


class AmpModem(StatefulOp):
    """AM demodulator (reference demod.hpp:221-307, wrapper.cpp:189-199):
    AmpModem(modulation=0.75, type='dsb', carrier=False).

    Semantics documented in tpudsp/kernels/ampmodem.py (PLL-coherent for
    carrier=True -- the topology the reference author endorses at
    demod.hpp:87-91 -- Hilbert sideband split for usb/lsb). Live-settable
    ``modulation``/``type``/``carrier`` properties rebuild the demodulator
    and reset its DSP state, matching the reference's rebuild-on-set
    behavior (demod.hpp:250-276, SURVEY.md Q5)."""

    def __init__(self, modulation=0.75, type="dsb", carrier=False):
        self._mod = float(modulation)
        self._type = type if type in ("dsb", "usb", "lsb") else "dsb"
        self._carrier = bool(carrier)
        self._h_hilb = jnp.asarray(firdes.hilbert_fir(kam.HILB_M, 60.0), jnp.float32)
        self._jit = {}
        self.reset()

    def reset(self):
        self._state = kam.ampdemod_init()

    # -- rebuild-on-set properties (wrapper.cpp:194-196) ----------------------
    @property
    def modulation(self):
        return self._mod

    @modulation.setter
    def modulation(self, mod):
        self._mod = float(mod)
        self.reset()

    @property
    def type(self):
        return self._type

    @type.setter
    def type(self, t):
        # reference: only accepts dsb/usb/lsb, otherwise ignores (demod.hpp:254-259)
        if t in ("dsb", "usb", "lsb"):
            self._type = t
            self.reset()

    @property
    def carrier(self):
        return self._carrier

    @carrier.setter
    def carrier(self, val):
        self._carrier = bool(val)
        self.reset()

    def print(self):
        print(
            f"ampmodem [modulation: {self._mod:.3f}, type: {self._type}, "
            f"carrier: {'present' if self._carrier else 'suppressed'}]"
        )

    def _fn(self):
        key = (self._type, self._carrier)
        if key not in self._jit:
            self._jit[key] = jax.jit(
                partial(kam.ampdemod_apply, am_type=self._type, carrier=self._carrier)
            )
        return self._jit[key]

    def __call__(self, inp):
        xj = as_c64(inp)
        self._state, y = self._fn()(self._state, xj, self._h_hilb, jnp.float32(self._mod))
        return np.asarray(y)


class SSBDemod(StatefulOp):
    """SSB demodulator via Hilbert sideband split (reference
    demod.hpp:155-187, wrapper.cpp:269-272): SSBDemod(band), band in
    {'usb','lsb'}; keeps the corresponding output of the c2r split."""

    HILB_M = 25  # reference uses firhilbf_create(25, 60) (demod.hpp:163)

    def __init__(self, band):
        self._usb = band == "usb"
        self._h = jnp.asarray(firdes.hilbert_fir(self.HILB_M, 60.0), jnp.float32)
        self._c2r = _c2r_apply
        self.reset()

    def reset(self):
        self._state = khilb.c2r_init(self.HILB_M)

    def __call__(self, inp):
        xj = as_c64(inp)
        self._state, (lower, upper) = self._c2r(self._h, self._state, xj)
        return np.asarray(upper if self._usb else lower)


def _fmstereo_block(h_state, x, *, h_aud, b0, a, dtheta_u32):
    """One jitted FMStereo block: freqdem -> block-parallel pilot-squaring
    L-R demod -> audio-band lowpass + stereo matrix -> 75us de-emphasis at
    iq_rate (reference stage order preserved, SURVEY.md Q3; pilot recovery
    re-architected per tpudsp/kernels/pll.py stereo_pilot_apply)."""
    prev, pilot, aud, dl, dr = h_state
    prev, s = kfd.freqdem_apply(jnp.float32(4.0), prev, x)  # kd=4.0 per demod.hpp:27
    pilot, lr = kpll.stereo_pilot_apply(pilot, s, jnp.uint32(dtheta_u32))
    aud, (left, right) = kpll.stereo_matrix_lowpass(h_aud, aud, s, lr)
    dl, yl = kiir.first_order_apply(jnp.float32(b0), jnp.float32(a), dl, left)
    dr, yr = kiir.first_order_apply(jnp.float32(b0), jnp.float32(a), dr, right)
    return (prev, pilot, aud, dl, dr), (yl, yr)


class FMStereo(StatefulOp):
    """Composite WBFM stereo decoder (reference demod.hpp:4-85,
    wrapper.cpp:264-267): FMStereo(iq_rate=600000.0, pcm_rate=48000.0).

    Stage order per the reference: freqdem(kd=4) -> pilot-coherent 38 kHz
    L-R demod -> audio-band lowpass -> per-channel 75us de-emphasis at
    iq_rate -> per-channel resample to pcm_rate -> (N, 2) float32 stereo
    array (the SURVEY.md Q3 disposition; the reference emits flat
    interleaved L,R). Reference quirks resolved per SURVEY.md Q3: only full
    L,R pairs are emitted; the pilot recovery itself is re-architected as a
    fully block-parallel pilot-squaring receiver (see
    tpudsp/kernels/pll.py stereo_pilot_apply -- the reference's PLL topology
    measurably diverges, demonstrated sample-serially in
    tests/test_oracle_composite.py), which also yields full-scale stereo
    separation (>=30 dB broadcast grade; the reference's Re(s e^{-2j theta})
    term is half-scale and measures ~1.4 dB even when force-locked).

    Block-parallel re-architecture (SURVEY.md section 3.4): every stage -- freqdem,
    pilot recovery, stereo matrix, de-emphasis, resamplers -- is block-
    parallel; there is no per-sample loop anywhere in this chain."""

    def __init__(self, iq_rate=600000.0, pcm_rate=48000.0):
        self._iq_rate = float(iq_rate)
        self._pcm_rate = float(pcm_rate)
        self._rate = self._pcm_rate / self._iq_rate
        b0, a = iirdes.deemphasis_coeffs(self._iq_rate)
        m, fc, As, npfb = firdes.default_resamp_params(self._rate)
        self._m = m
        self._H = jnp.asarray(firdes.resamp_bank(m, fc, As, npfb), jnp.float32)
        self._h_aud = jnp.asarray(firdes.stereo_audio_lowpass(self._iq_rate),
                                  jnp.float32)
        from ..kernels import nco as knco
        dtheta = knco.rad_to_u32(2.0 * np.pi * 19000.0 / self._iq_rate)
        self._block = jax.jit(partial(_fmstereo_block, h_aud=self._h_aud,
                                      b0=b0, a=a, dtheta_u32=dtheta))
        self._resamp = jax.jit(krs.resamp_apply)
        self.reset()

    def reset(self):
        # reference reset() only resets the resamplers (demod.hpp:34-37);
        # we reset the full chain state -- the documented intent
        from ..kernels import fir as kfir
        self._state = (
            kfd.freqdem_init(),
            kpll.stereo_pilot_init(),
            kfir.fir_init(self._h_aud.shape[0], jnp.complex64),
            jnp.float32(0.0),
            jnp.float32(0.0),
        )
        self._rs_l = krs.resamp_init(2 * self._m, jnp.float32)
        self._rs_r = krs.resamp_init(2 * self._m, jnp.float32)
        self._tau = 0.0

    @property
    def state(self):
        """Full checkpointable state: block pytree + resampler tails/phase."""
        return {
            "block": jax.tree.map(np.asarray, self._state),
            "rs_l": np.asarray(self._rs_l),
            "rs_r": np.asarray(self._rs_r),
            "tau": self._tau,
        }

    def with_state(self, state):
        self._state = jax.tree.map(jnp.asarray, state["block"])
        self._rs_l = jnp.asarray(state["rs_l"])
        self._rs_r = jnp.asarray(state["rs_r"])
        self._tau = float(state["tau"])
        return self

    def __call__(self, inp):
        xj = as_c64(inp)
        self._state, (yl, yr) = self._block(self._state, xj)
        n_out, q, frac, new_tau = krs.plan(self._tau, int(xj.shape[0]), self._rate)
        if n_out == 0:
            ntaps = 2 * self._m
            self._rs_l = jnp.concatenate([self._rs_l, yl])[-ntaps:]
            self._rs_r = jnp.concatenate([self._rs_r, yr])[-ntaps:]
            self._tau = new_tau
            return np.zeros((0, 2), np.float32)
        qj, fj = jnp.asarray(q), jnp.asarray(frac)
        self._rs_l, pl = self._resamp(self._H, self._rs_l, yl, qj, fj)
        self._rs_r, pr = self._resamp(self._H, self._rs_r, yr, qj, fj)
        self._tau = new_tau
        return np.stack([np.asarray(pl), np.asarray(pr)], axis=1)


def _broadcastam_block(state, x, *, h_lp, sos_dc, m, exact_pll):
    """One jitted BroadcastAM block (reference demod.hpp:93-153 topology):
    narrow lowpass -> carrier PLL on filtered path -> mix the *delayed*
    wideband path by the recovered carrier -> Re -> cheby2 HPF DC block."""
    fir_tail, delay_buf, pll_state, dc_state = state
    fir_tail, x0 = kfir.fir_apply(h_lp, fir_tail, x)
    delay_buf, x1 = kfir.delay_apply(delay_buf, x)
    scan = kpll.pll_carrier_scan if exact_pll else kpll.pll_carrier_scan_chunked
    pll_state, thetas = scan(pll_state, x0, 0.001)  # bw per demod.hpp:104
    v1 = x1 * jnp.exp(-1j * thetas)
    # fc=20/48000 puts the HPF poles at radius ~0.9983: run the DC block
    # through the compensated scan (plain f32 floors for near-unit poles)
    dc_state, y = kiir.sos_apply_df(sos_dc, dc_state,
                                    v1.real.astype(jnp.float32))
    return (fir_tail, delay_buf, pll_state, dc_state), y


class BroadcastAM(StatefulOp):
    """Coherent AM for broadcast audio (reference demod.hpp:93-153,
    wrapper.cpp:259-262): BroadcastAM(slen=25).

    Per the reference: Kaiser lowpass (2*slen+1 taps, Fc=0.01, As=40) feeds
    a carrier PLL (bw 0.001); the wideband path, delayed by slen to match
    the filter's group delay, is mixed down by the recovered carrier; the
    real part is DC-blocked by a cheby2 highpass (order 3, fc=20/48000)."""

    def __init__(self, slen=25, exact_pll=True):
        self._m = int(slen)
        h = firdes.kaiser_lowpass(2 * self._m + 1, 0.01, 40.0)
        self._h_lp = jnp.asarray(h, jnp.float32)
        sos = iirdes.iirdes_sos("cheby2", "highpass", 3, 20.0 / 48000.0,
                                Ap=0.5, As=20.0)
        self._sos_dc = kiir.sos_split_df(sos)
        self._n_sos = len(sos)
        self._block = jax.jit(
            partial(_broadcastam_block, h_lp=self._h_lp, sos_dc=self._sos_dc,
                    m=self._m, exact_pll=exact_pll)
        )
        self.reset()

    def reset(self):
        self._state = (
            kfir.fir_init(2 * self._m + 1, jnp.complex64),
            kfir.delay_init(self._m, jnp.complex64),
            kpll.pll_init(),
            kiir.sos_init(np.zeros((self._n_sos, 6)), jnp.float32),
        )

    def __call__(self, inp):
        xj = as_c64(inp)
        self._state, y = self._block(self._state, xj)
        return np.asarray(y)
