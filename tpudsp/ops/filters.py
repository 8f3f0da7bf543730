"""IIR / FIR filter op classes (reference wrapper.cpp parity).

Mirrors: CIIRFilter, CLowpassIIR, CHighpassIIR, CBandpassIIR, CBandstopIIR,
RIIRFilter, RLowpassIIR, RHighpassIIR, RBandpassIIR, RBandstopIIR,
ComplexIIRFilter, RealIIRFilter, DeemphasisFilter (iirfilter.hpp),
RealFIRFilter, RealDCBlocker, RealKaiserBessel (firfilter.hpp).

Execution is block-parallel: LTI IIR filters run by default as truncated-
impulse-response overlap-save convolutions (fully parallel; exact to
float32, see tpudsp/design/iirdes.py) and fall back to the associative-
scan SOS cascade when the response decays too slowly; `mode=` overrides.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..design import firdes, iirdes
from ..kernels import fir as kfir
from ..kernels import iir as kiir
from .base import StatefulOp, as_c64, as_f32

_sos_apply_df = jax.jit(kiir.sos_apply_df)
_fir_apply = jax.jit(partial(kfir.fir_apply, method="auto"))
_first_order = jax.jit(kiir.first_order_apply)

# truncated-IR execution is used when the impulse response fits in this many
# taps (else associative-scan recurrence). 64k taps is still cheap as an
# overlap-save FFT (131072-point FFTs), and it pushes the scan fallback --
# whose f32 associative scan sits near the precision floor for near-unit
# poles -- out to filters with multi-second impulse responses.
TIR_MAX_TAPS = 65536


class _SosFilterBase(StatefulOp):
    """Shared engine for all LTI IIR ops."""

    def __init__(self, sos: np.ndarray, complex_data: bool, mode: str = "auto"):
        self._sos = np.asarray(sos, dtype=np.float64)
        self._complex = complex_data
        self._dtype = jnp.complex64 if complex_data else jnp.float32
        self._tir_taps = None
        if mode in ("auto", "tir"):
            h = iirdes.sos_impulse_response(self._sos, max_len=TIR_MAX_TAPS)
            if h is not None:
                self._tir_taps = jnp.asarray(h, jnp.float32)
        if mode == "tir" and self._tir_taps is None:
            raise ValueError("impulse response does not decay within TIR budget")
        if mode == "scan":
            self._tir_taps = None
        # scan mode runs the compensated (double-float) cascade: the plain
        # f32 scan floors near 60 dB for low-Fc high-Q designs, the df
        # scan measures ~147 dB on the same (kernels/iir.py sos_split_df)
        self._sos_df = None if self._tir_taps is not None \
            else kiir.sos_split_df(self._sos)
        self.reset()

    @property
    def mode(self) -> str:
        return "tir" if self._tir_taps is not None else "scan"

    def reset(self):
        """Clear filter memory (liquid iirfilt_*_reset)."""
        if self._tir_taps is not None:
            self._state = kfir.fir_init(self._tir_taps.shape[0], self._dtype)
        else:
            self._state = kiir.sos_init(self._sos, self._dtype)

    def freqresponse(self, f):
        """H(e^{j2 pi f}) at f in cycles/sample (liquid iirfilt_*_freqresponse)."""
        return iirdes.sos_freqresponse(self._sos, f)

    def print(self):
        S = len(self._sos)
        print(f"iirfilt [sos: {S} sections, mode: {self.mode}]")
        for s, row in enumerate(self._sos):
            print(f"  {s}: b={row[:3]} a={row[3:]}")

    def _run(self, xj):
        if self._tir_taps is not None:
            self._state, y = _fir_apply(self._tir_taps, self._state, xj)
        else:
            self._state, y = _sos_apply_df(self._sos_df, self._state, xj)
        return np.asarray(y)

    def __call__(self, inp):
        xj = as_c64(inp) if self._complex else as_f32(inp)
        return self._run(xj)


class CIIRFilter(_SosFilterBase):
    """Complex-input IIR from explicit transfer-function coefficient arrays
    (reference iirfilter.hpp:23-59, wrapper.cpp:30-34: CIIRFilter(Bc, Ac))."""

    def __init__(self, Bc, Ac, mode: str = "auto"):
        super().__init__(iirdes.tf2sos(Bc, Ac), complex_data=True, mode=mode)


class RIIRFilter(_SosFilterBase):
    """Real twin of CIIRFilter (reference iirfilter.hpp:133-175)."""

    def __init__(self, Bc, Ac, mode: str = "auto"):
        super().__init__(iirdes.tf2sos(Bc, Ac), complex_data=False, mode=mode)


def _designed(band_type, complex_data):
    class _Designed(_SosFilterBase):
        def __init__(self, filter_type="butter", order=None, Fc=None, F0=None,
                     Ap=0.5, As=20.0, mode="auto"):
            if order is None or Fc is None:
                raise TypeError("order and Fc are required")
            if band_type in ("bandpass", "bandstop") and F0 is None:
                raise TypeError("F0 is required for band filters")
            # unknown filter_type falls back to butter, as the reference's
            # map lookup does (iirfilter.hpp:66-69)
            if filter_type not in iirdes.FILTER_TYPES:
                filter_type = "butter"
            sos = iirdes.iirdes_sos(filter_type, band_type, order, Fc,
                                    F0 if F0 is not None else 0.1, Ap, As)
            super().__init__(sos, complex_data=complex_data, mode=mode)
    return _Designed


class CLowpassIIR(_designed("lowpass", True)):
    """Designed complex lowpass IIR (reference iirfilter.hpp:61-77,
    wrapper.cpp:36-46): (filter_type='butter', order, Fc, Ap=0.5, As=20)."""


class CHighpassIIR(_designed("highpass", True)):
    """Reference iirfilter.hpp:79-95, wrapper.cpp:48-58."""


class CBandpassIIR(_designed("bandpass", True)):
    """Reference iirfilter.hpp:97-113, wrapper.cpp:60-69. Band edges F0 +/- Fc."""


class CBandstopIIR(_designed("bandstop", True)):
    """Reference iirfilter.hpp:115-131, wrapper.cpp:71-80."""


class RLowpassIIR(_designed("lowpass", False)):
    """Reference iirfilter.hpp:177-193, wrapper.cpp:82-92."""


class RHighpassIIR(_designed("highpass", False)):
    """Reference iirfilter.hpp:195-211, wrapper.cpp:94-104."""


class RBandpassIIR(_designed("bandpass", False)):
    """Reference iirfilter.hpp:213-227, wrapper.cpp:106-115."""


class RBandstopIIR(_designed("bandstop", False)):
    """Reference iirfilter.hpp:229-241, wrapper.cpp:117-126."""


class _FullIIR(_SosFilterBase):
    """One-stop designed IIR with band_type kwarg + readonly design params
    (reference iirfilter.hpp:244-356, wrapper.cpp:134-172)."""

    _complex_data = True

    def __init__(self, filter_type="butter", band_type="lowpass", order=2,
                 Fc=0.2, F0=0.3, Ap=0.7, As=60.0, mode="auto"):
        # readonly attributes per wrapper.cpp def_readonly; fall back to the
        # defaults exactly as the reference's map lookups do
        self.filter_type = filter_type if filter_type in iirdes.FILTER_TYPES else "butter"
        self.band_type = band_type if band_type in iirdes.BAND_TYPES else "lowpass"
        self.order = int(order)
        self.Fc = float(Fc)
        self.F0 = float(F0)
        self.Ap = float(Ap)
        self.As = float(As)
        sos = iirdes.iirdes_sos(self.filter_type, self.band_type, self.order,
                                self.Fc, self.F0, self.Ap, self.As)
        super().__init__(sos, complex_data=self._complex_data, mode=mode)


class ComplexIIRFilter(_FullIIR):
    """Reference wrapper.cpp:134-152: ComplexIIRFilter(filter_type='butter',
    band_type='lowpass', order=2, Fc=0.2, F0=0.3, Ap=0.7, As=60.0)."""
    _complex_data = True


class RealIIRFilter(_FullIIR):
    """Reference wrapper.cpp:154-172: real twin."""
    _complex_data = False


class DeemphasisFilter(StatefulOp):
    """FM 75 us de-emphasis one-pole IIR (reference iirfilter.hpp:358-392,
    wrapper.cpp:178-181): y[n] = (1-x) u[n] + x y[n-1],
    x = exp(-1/(75e-6 * sample_rate))."""

    def __init__(self, sample_rate=48000):
        self._b0, self._a = iirdes.deemphasis_coeffs(sample_rate)
        self._state = jnp.float32(0.0)

    def reset(self):
        self._state = jnp.float32(0.0)

    def freqresponse(self, f):
        sos = np.array([[self._b0, 0.0, 0.0, 1.0, -self._a, 0.0]])
        return iirdes.sos_freqresponse(sos, f)

    def __call__(self, data):
        xj = as_f32(data)
        self._state, y = _first_order(
            jnp.float32(self._b0), jnp.float32(self._a), self._state, xj
        )
        return np.asarray(y)


class RealFIRFilter(StatefulOp):
    """Real FIR from explicit taps (reference firfilter.hpp:5-36,
    wrapper.cpp:244-247): y[n] = sum_k h[k] x[n-k]."""

    def __init__(self, h=None):
        if h is not None:
            self._set_taps(np.asarray(h, dtype=np.float64))

    def _set_taps(self, h):
        self._h = h
        self._hj = jnp.asarray(h, jnp.float32)
        self.reset()

    def reset(self):
        self._state = kfir.fir_init(len(self._h), jnp.float32)

    def freqresponse(self, f):
        return firdes.freqresponse(self._h, f)

    def __call__(self, inp):
        xj = as_f32(inp)
        self._state, y = _fir_apply(self._hj, self._state, xj)
        return np.asarray(y)


class RealDCBlocker(RealFIRFilter):
    """DC-notch FIR (reference firfilter.hpp:39-50, wrapper.cpp:249-252):
    RealDCBlocker(slen=25, As=20)."""

    def __init__(self, slen=25, As=20.0):
        self._set_taps(firdes.dc_blocker(slen, As))


class RealKaiserBessel(RealFIRFilter):
    """Kaiser-windowed lowpass FIR, self-normalized to unity DC gain
    (reference firfilter.hpp:52-67: set_scale(1/|H(0)|)):
    RealKaiserBessel(flen=25, Fc, As=20, offset=0)."""

    def __init__(self, flen=25, Fc=None, As=20.0, offset=0.0):
        if Fc is None:
            raise TypeError("Fc is required")
        h = firdes.kaiser_lowpass(flen, Fc, As, offset)
        h = h / abs(firdes.freqresponse(h, 0.0))
        self._set_taps(h)
