"""Executable specification of the reference primitives (sample-serial NumPy).

The reference has zero tests (SURVEY.md section 4); this module is the
from-scratch golden spec: a direct, slow, sample-at-a-time float64
re-implementation of each liquid-dsp primitive's *documented/intended*
semantics, written down from the behavior recorded in SURVEY.md section 2.
Every kernel in tpudsp/kernels is validated against these loops to
>= 60 dB SNR (BASELINE.md) and to block-invariance under arbitrary splits.

These loops intentionally share no code with tpudsp/kernels (different
formulation: per-sample recurrence here, scan/overlap-save there), so an
agreement between the two is meaningful evidence of correctness.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi
U32 = np.uint64(1) << np.uint64(32)


# ---------------------------------------------------------------------------
# IIR: SOS cascade, transposed direct form II (liquid iirfilt_* semantics,
# reference iirfilter.hpp:52-58)
# ---------------------------------------------------------------------------
class SosFilterOracle:
    def __init__(self, sos: np.ndarray):
        self.sos = np.asarray(sos, dtype=np.float64)
        self.state = np.zeros((len(self.sos), 2), dtype=np.complex128)

    def reset(self):
        self.state[:] = 0

    def __call__(self, x: np.ndarray) -> np.ndarray:
        complex_in = np.iscomplexobj(x)
        y = np.asarray(x).astype(np.complex128)
        for s, (b0, b1, b2, _, a1, a2) in enumerate(self.sos):
            s1, s2 = self.state[s]
            out = np.empty_like(y)
            for n in range(len(y)):
                xn = y[n]
                yn = b0 * xn + s1
                s1 = b1 * xn - a1 * yn + s2
                s2 = b2 * xn - a2 * yn
                out[n] = yn
            self.state[s] = (s1, s2)
            y = out
        return y if complex_in else y.real


class FirstOrderOracle:
    """y[n] = b0*x[n] + a*y[n-1] (deemphasis, reference iirfilter.hpp:384-391)."""

    def __init__(self, b0: float, a: float):
        self.b0, self.a = b0, a
        self.y1 = 0.0

    def reset(self):
        self.y1 = 0.0

    def __call__(self, x):
        out = np.empty(len(x))
        y1 = self.y1
        for n in range(len(x)):
            y1 = self.b0 * x[n] + self.a * y1
            out[n] = y1
        self.y1 = y1
        return out


# ---------------------------------------------------------------------------
# FIR: y[n] = sum_k h[k] x[n-k] (liquid firfilt_*, reference firfilter.hpp:29-35)
# ---------------------------------------------------------------------------
class FirFilterOracle:
    def __init__(self, h: np.ndarray, complex_data: bool = False):
        self.h = np.asarray(h, dtype=np.float64)
        n = len(self.h)
        self.buf = np.zeros(n - 1, dtype=np.complex128 if complex_data else np.float64)

    def reset(self):
        self.buf[:] = 0

    def __call__(self, x):
        xx = np.concatenate([self.buf, np.asarray(x)])
        K = len(self.h)
        out = np.empty(len(x), dtype=xx.dtype)
        for n in range(len(x)):
            # window ending at current sample, newest-first dot with h
            w = xx[n : n + K][::-1]
            out[n] = np.dot(self.h, w)
        if K > 1:
            self.buf = xx[-(K - 1) :]
        return out


# ---------------------------------------------------------------------------
# Delay line (liquid wdelay{f,cf}: read-before-push, reference utility.hpp:41-53)
# ---------------------------------------------------------------------------
class DelayOracle:
    def __init__(self, nd: int, complex_data: bool = False):
        self.nd = nd
        self.buf = np.zeros(nd, dtype=np.complex128 if complex_data else np.float64)

    def __call__(self, x):
        out = np.empty(len(x), dtype=self.buf.dtype if self.nd else np.asarray(x).dtype)
        if self.nd == 0:
            return np.asarray(x).copy()
        buf = list(self.buf)
        for n in range(len(x)):
            out[n] = buf[0]
            buf.pop(0)
            buf.append(x[n])
        self.buf = np.array(buf, dtype=self.buf.dtype)
        return out


# ---------------------------------------------------------------------------
# NCO: uint32 phase accumulator (liquid nco_crcf, SURVEY.md section 2.2:
# 32-bit integer phase; reference nco.hpp)
# ---------------------------------------------------------------------------
def _rad_to_u32(theta: float) -> np.uint64:
    return np.uint64(int(round((theta % TWO_PI) / TWO_PI * float(U32)))) % U32


class NcoOracle:
    def __init__(self):
        self.phase_u = np.uint64(0)
        self.dtheta_u = np.uint64(0)
        self.freq_f = 0.0
        self.alpha = 0.1            # pll: freq gain = bandwidth
        self.beta = np.sqrt(0.1)    # pll: phase gain = sqrt(bandwidth)

    @property
    def phase(self):
        return float(self.phase_u) / float(U32) * TWO_PI

    def set_phase(self, theta):
        self.phase_u = _rad_to_u32(theta)

    def set_frequency(self, f):
        self.freq_f = float(f)
        self.dtheta_u = _rad_to_u32(f)

    def set_pll_bandwidth(self, bw):
        self.alpha = bw
        self.beta = np.sqrt(bw)

    def pll_step(self, dphi):
        self.set_frequency(self.freq_f + self.alpha * dphi)
        self.set_phase(self.phase + self.beta * dphi)

    def step(self):
        self.phase_u = (self.phase_u + self.dtheta_u) % U32

    def mix_up(self, x):
        out = np.empty(len(x), dtype=np.complex128)
        for n in range(len(x)):
            out[n] = x[n] * np.exp(1j * self.phase)
            self.step()
        return out

    def mix_down(self, x):
        out = np.empty(len(x), dtype=np.complex128)
        for n in range(len(x)):
            out[n] = x[n] * np.exp(-1j * self.phase)
            self.step()
        return out


# ---------------------------------------------------------------------------
# AGC + squelch FSM (liquid agc_crcf; state values documented in the
# reference's own docstrings, agc_docs.cpp:53-72)
# ---------------------------------------------------------------------------
SQ_UNKNOWN, SQ_ENABLED, SQ_RISE, SQ_SIGNALHI, SQ_FALL = 0, 1, 2, 3, 4
SQ_SIGNALLO, SQ_TIMEOUT, SQ_DISABLED = 5, 6, 7


class AgcOracle:
    def __init__(self, bandwidth=0.01, timeout=100):
        self.alpha = bandwidth
        self.g = 1.0
        self.y2_prime = 1.0
        self.scale = 1.0
        self.locked = False
        self.squelch_enabled = False
        self.threshold = 0.0
        self.timeout = timeout
        self.sq_mode = SQ_DISABLED
        self.sq_timer = timeout

    def reset(self):
        self.g = 1.0
        self.y2_prime = 1.0
        self.locked = False
        self.sq_mode = SQ_ENABLED if self.squelch_enabled else SQ_DISABLED

    @property
    def rssi(self):
        return -20.0 * np.log10(self.g)

    def _squelch_update(self):
        high = self.rssi > self.threshold
        m = self.sq_mode
        if m == SQ_DISABLED:
            return
        if m in (SQ_UNKNOWN, SQ_ENABLED):
            self.sq_mode = SQ_RISE if high else SQ_ENABLED
        elif m == SQ_RISE:
            self.sq_mode = SQ_SIGNALHI if high else SQ_FALL
        elif m == SQ_SIGNALHI:
            if not high:
                self.sq_mode = SQ_FALL
        elif m == SQ_FALL:
            self.sq_mode = SQ_SIGNALHI if high else SQ_SIGNALLO
            self.sq_timer = self.timeout
        elif m == SQ_SIGNALLO:
            if high:
                self.sq_mode = SQ_SIGNALHI
            else:
                self.sq_timer -= 1
                if self.sq_timer <= 0:
                    self.sq_mode = SQ_TIMEOUT
        elif m == SQ_TIMEOUT:
            self.sq_mode = SQ_ENABLED

    def __call__(self, x):
        out = np.empty(len(x), dtype=np.complex128)
        modes = np.empty(len(x), dtype=np.int64)
        for n in range(len(x)):
            y = x[n] * self.g
            y2 = abs(y) ** 2
            self.y2_prime = (1 - self.alpha) * self.y2_prime + self.alpha * y2
            if not self.locked:
                self.g *= np.exp(-0.5 * self.alpha * np.log(self.y2_prime + 1e-30))
                self.g = min(self.g, 1e6)
            if self.squelch_enabled:
                self._squelch_update()
            modes[n] = self.sq_mode
            if self.sq_mode in (SQ_ENABLED, SQ_SIGNALLO):
                out[n] = 0.0
            else:
                out[n] = y * self.scale
        return out, modes


# ---------------------------------------------------------------------------
# FM demodulator (liquid freqdem, reference demod.hpp:189-219):
# y[n] = arg(conj(x[n-1]) * x[n]) / (2 pi kd)
# ---------------------------------------------------------------------------
class FreqDemOracle:
    def __init__(self, kd: float):
        self.kd = kd
        self.prev = 1.0 + 0.0j

    def reset(self):
        self.prev = 1.0 + 0.0j

    def __call__(self, x):
        out = np.empty(len(x))
        prev = self.prev
        for n in range(len(x)):
            out[n] = np.angle(np.conj(prev) * x[n]) / (TWO_PI * self.kd)
            prev = x[n]
        self.prev = prev
        return out


# ---------------------------------------------------------------------------
# Polyphase arbitrary-rate resampler (liquid resamp_* semantics,
# reference resampler.hpp; shapes-planned reformulation per SURVEY.md Q4/Q8)
# ---------------------------------------------------------------------------
class ResampOracle:
    """Sample-serial evaluation of the exact semantics the kernel plans:
    output k at continuous input position p_k = tau + k/rate, window
    X[q : q+2m] (X = [2m-sample history, block]), polyphase bank selected by
    frac(p_k) with linear interpolation between adjacent banks."""

    def __init__(self, H: np.ndarray, rate: float, complex_data=False):
        self.H = np.asarray(H, dtype=np.float64)  # (npfb+1, 2m)
        self.npfb = self.H.shape[0] - 1
        self.ntaps = self.H.shape[1]
        self.rate = float(rate)
        self.tau = 0.0
        self.buf = np.zeros(self.ntaps, dtype=np.complex128 if complex_data else np.float64)

    def reset(self):
        self.tau = 0.0
        self.buf[:] = 0

    def __call__(self, x):
        X = np.concatenate([self.buf, np.asarray(x)])
        N = len(x)
        outs = []
        tau = self.tau
        k = 0
        while tau + k / self.rate < N - 1e-12:
            p = tau + k / self.rate
            q = int(np.floor(p))
            f = p - q
            fb = f * self.npfb
            b = int(np.floor(fb))
            w = fb - b
            taps = (1 - w) * self.H[b] + w * self.H[b + 1]
            outs.append(np.dot(X[q : q + self.ntaps], taps))
            k += 1
        self.tau = tau + k / self.rate - N
        self.buf = X[-self.ntaps :]
        return np.array(outs, dtype=X.dtype)


# ---------------------------------------------------------------------------
# PLL carrier-recovery loop (the per-sample feedback pattern shared by
# BroadcastAM / ampmodem-with-carrier / FMStereo pilot, reference
# demod.hpp:54-84, 133-152)
# ---------------------------------------------------------------------------
class PllOracle:
    def __init__(self, bandwidth: float):
        self.nco = NcoOracle()
        self.nco.set_pll_bandwidth(bandwidth)

    def run(self, x):
        """Per sample: v = x * e^{-j theta}; err = arg(v); pll_step(err); step.
        Returns the theta used per sample."""
        thetas = np.empty(len(x))
        for n in range(len(x)):
            th = self.nco.phase
            thetas[n] = th
            v = x[n] * np.exp(-1j * th)
            err = np.angle(v)
            self.nco.pll_step(err)
            self.nco.step()
        return thetas
