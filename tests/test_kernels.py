"""Kernel-vs-oracle golden tests (SURVEY.md section 4 class 1) and
block-invariance tests (class 2): f(concat(a,b)) == concat(f(a), f(b))."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpudsp.design import firdes, iirdes
from tpudsp.kernels import agc as kagc
from tpudsp.kernels import fir as kfir
from tpudsp.kernels import freqdem as kfd
from tpudsp.kernels import hilbert as khilb
from tpudsp.kernels import iir as kiir
from tpudsp.kernels import nco as knco
from tpudsp.kernels import pll as kpll
from tpudsp.kernels import resamp as krs

from tests.oracle.liquid_oracle import (
    AgcOracle, DelayOracle, FirFilterOracle, FirstOrderOracle, FreqDemOracle,
    NcoOracle, PllOracle, ResampOracle, SosFilterOracle,
)
from tests.util import noise, snr_db, tones

SNR_REQ = 60.0


# ---------------------------------------------------------------------------
# IIR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ftype,order,fc,req", [
    ("butter", 4, 0.1, SNR_REQ), ("cheby2", 8, 0.0075, 55.0),
    ("ellip", 5, 0.2, SNR_REQ), ("cheby1", 3, 0.05, SNR_REQ),
])
def test_sos_scan_vs_oracle_complex(ftype, order, fc, req):
    # Note: the cheby2 order-8 Fc=0.0075 case (the README's own AM bandpass
    # config) sits at the float32 recurrence precision floor in scan mode
    # (~59.6 dB); the *default* truncated-IR mode delivers >120 dB for it
    # (test_truncated_ir_matches_sos), which is what the op classes use.
    sos = iirdes.iirdes_sos(ftype, "lowpass", order, fc, As=60.0, Ap=0.5)
    x = noise(4096, complex_out=True, seed=1)
    orc = SosFilterOracle(sos)
    y_ref = orc(x)
    st = kiir.sos_init(sos, jnp.complex64)
    _, y = jax.jit(kiir.sos_apply)(
        jnp.asarray(sos, jnp.float32), st, jnp.asarray(x, jnp.complex64)
    )
    assert snr_db(y_ref, np.asarray(y)) > req


def test_sos_scan_block_invariance():
    sos = iirdes.iirdes_sos("cheby2", "lowpass", 8, Fc=0.0075, As=60.0)
    sos_j = jnp.asarray(sos, jnp.float32)
    x = noise(3000, complex_out=True, seed=2).astype(np.complex64)
    st = kiir.sos_init(sos, jnp.complex64)
    _, y_full = kiir.sos_apply(sos_j, st, jnp.asarray(x))
    st = kiir.sos_init(sos, jnp.complex64)
    parts = []
    for piece in (x[:7], x[7:1000], x[1000:1001], x[1001:]):
        st, yp = kiir.sos_apply(sos_j, st, jnp.asarray(piece))
        parts.append(np.asarray(yp))
    y_cat = np.concatenate(parts)
    # different split points give different f32 scan-tree rounding; require
    # agreement far below the 60 dB fidelity bar
    assert snr_db(np.asarray(y_full), y_cat) > 70.0


def test_truncated_ir_matches_sos():
    sos = iirdes.iirdes_sos("cheby2", "lowpass", 8, 0.0075, As=60.0)
    h = iirdes.sos_impulse_response(sos)
    assert h is not None
    x = noise(8192, complex_out=True, seed=3)
    y_ref = SosFilterOracle(sos)(x)
    tail = kfir.fir_init(len(h), jnp.complex64)
    _, y = kfir.fir_apply(jnp.asarray(h, jnp.float32), tail, jnp.asarray(x, jnp.complex64))
    assert snr_db(y_ref, np.asarray(y)) > SNR_REQ


def test_first_order_vs_oracle():
    b0, a = iirdes.deemphasis_coeffs(48000.0)
    x = noise(2048, complex_out=False, seed=4)
    orc = FirstOrderOracle(b0, a)
    y_ref = orc(x)
    _, y = kiir.first_order_apply(jnp.float32(b0), jnp.float32(a), jnp.float32(0.0),
                                  jnp.asarray(x, jnp.float32))
    assert snr_db(y_ref, np.asarray(y)) > SNR_REQ


# ---------------------------------------------------------------------------
# FIR
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ntaps,method", [(25, "direct"), (257, "fft"), (1025, "fft")])
def test_fir_vs_oracle(ntaps, method):
    h = firdes.kaiser_lowpass(ntaps, 0.2, 60.0)
    x = noise(5000, complex_out=True, seed=5)
    orc = FirFilterOracle(h, complex_data=True)
    y_ref = orc(x)
    tail = kfir.fir_init(ntaps, jnp.complex64)
    _, y = kfir.fir_apply(jnp.asarray(h, jnp.float32), tail, jnp.asarray(x, jnp.complex64),
                          method=method)
    assert snr_db(y_ref, np.asarray(y)) > SNR_REQ


def test_fir_block_invariance_fft():
    h = firdes.kaiser_lowpass(301, 0.1, 80.0)
    hj = jnp.asarray(h, jnp.float32)
    x = noise(4000, complex_out=False, seed=6).astype(np.float32)
    tail = kfir.fir_init(301, jnp.float32)
    _, y_full = kfir.fir_apply(hj, tail, jnp.asarray(x))
    tail = kfir.fir_init(301, jnp.float32)
    parts = []
    for piece in (x[:113], x[113:2000], x[2000:]):
        tail, yp = kfir.fir_apply(hj, tail, jnp.asarray(piece))
        parts.append(np.asarray(yp))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(y_full), atol=2e-5)


def test_delay_vs_oracle():
    x = noise(100, complex_out=True, seed=7)
    orc = DelayOracle(11, complex_data=True)
    y_ref = np.concatenate([orc(x[:37]), orc(x[37:])])
    buf = kfir.delay_init(11, jnp.complex64)
    buf, y1 = kfir.delay_apply(buf, jnp.asarray(x[:37], jnp.complex64))
    _, y2 = kfir.delay_apply(buf, jnp.asarray(x[37:], jnp.complex64))
    np.testing.assert_allclose(np.concatenate([np.asarray(y1), np.asarray(y2)]), y_ref, atol=1e-6)


# ---------------------------------------------------------------------------
# NCO
# ---------------------------------------------------------------------------
def test_nco_mix_vs_oracle():
    f = 0.123456
    orc = NcoOracle()
    orc.set_frequency(2 * np.pi * f)
    x = noise(4096, complex_out=True, seed=8)
    y_ref = orc.mix_up(x)
    ph = jnp.uint32(0)
    dth = jnp.uint32(knco.rad_to_u32(2 * np.pi * f))
    ph, y1 = knco.mix_up(ph, dth, jnp.asarray(x[:1000], jnp.complex64))
    _, y2 = knco.mix_up(ph, dth, jnp.asarray(x[1000:], jnp.complex64))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert snr_db(y_ref, y) > SNR_REQ


def test_nco_mix_down_inverts_up():
    dth = jnp.uint32(knco.rad_to_u32(0.7))
    x = jnp.asarray(noise(512, seed=9), jnp.complex64)
    _, up = knco.mix_up(jnp.uint32(5), dth, x)
    _, back = knco.mix_down(jnp.uint32(5), dth, up)
    assert snr_db(np.asarray(x), np.asarray(back)) > 100.0


# ---------------------------------------------------------------------------
# AGC
# ---------------------------------------------------------------------------
def _agc_signal(n=6000):
    x = tones(n, [0.01], complex_out=True)
    amp = np.where(np.arange(n) < n // 2, 0.05, 0.5)
    return (x * amp).astype(np.complex128)


def test_agc_vs_oracle():
    x = _agc_signal()
    orc = AgcOracle(bandwidth=0.01)
    orc.squelch_enabled = False
    orc.sq_mode = 7
    y_ref, _ = orc(x)
    params = kagc.make_params(alpha=0.01)
    st = kagc.agc_init()
    st, (y1, _) = kagc.agc_apply(params, st, jnp.asarray(x[:2500], jnp.complex64))
    _, (y2, _) = kagc.agc_apply(params, st, jnp.asarray(x[2500:], jnp.complex64))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert snr_db(y_ref, y) > SNR_REQ


def test_agc_squelch_fsm_vs_oracle():
    n = 4000
    x = tones(n, [0.02], complex_out=True)
    amp = np.where((np.arange(n) > 1000) & (np.arange(n) < 2500), 1.0, 0.001)
    x = x * amp
    orc = AgcOracle(bandwidth=0.05)
    orc.squelch_enabled = True
    orc.threshold = 20.0
    orc.sq_mode = 1
    y_ref, modes_ref = orc(x)
    params = kagc.make_params(alpha=0.05, squelch=True, threshold=20.0)
    st = kagc.agc_init(squelch=True)
    _, (y, modes) = kagc.agc_apply(params, st, jnp.asarray(x, jnp.complex64))
    assert np.mean(np.asarray(modes) == modes_ref) > 0.999
    assert (np.asarray(modes) == kagc.SQ_RISE).sum() >= 1


def test_agc_chunked_small_alpha_derived_warmup():
    """Regression (round-1 VERDICT weak #1): the warmup window must follow
    the loop bandwidth. At alpha=1e-3 the coupled gain/level loop's memory
    is ~3000 samples (measured decay exp(-alpha n/3)); the previously
    frozen warmup=2048 gives ~6 dB and fails the 60 dB bar, while the
    derived window (kernels/warmup.warmup_for -> 36096) passes with
    margin."""
    from tpudsp.kernels.warmup import chunk_for, warmup_for
    x = _agc_signal(120000)
    params = kagc.make_params(alpha=1e-3)
    st = kagc.agc_init()
    _, (y_exact, _) = kagc.agc_apply(params, st, jnp.asarray(x, jnp.complex64))
    w = warmup_for(agc_alpha=1e-3)
    assert w >= 10_000  # >= 10x the loop memory per the project invariant
    st = kagc.agc_init()
    _, (y_der, _) = kagc.agc_apply_chunked(
        params, st, jnp.asarray(x, jnp.complex64),
        chunk=chunk_for(w), warmup=w)
    assert snr_db(np.asarray(y_exact), np.asarray(y_der)) > SNR_REQ
    # and the op derives it automatically
    import tpudsp
    a1, a2 = tpudsp.AGC(), tpudsp.AGC(throughput_mode=True)
    a1.bandwidth = a2.bandwidth = 1e-3
    y1, y2 = a1(x), a2(x)
    assert snr_db(y1, y2) > SNR_REQ
    # the old frozen constants demonstrably fail at this bandwidth
    st = kagc.agc_init()
    _, (y_old, _) = kagc.agc_apply_chunked(
        params, st, jnp.asarray(x, jnp.complex64), chunk=1024, warmup=2048)
    assert snr_db(np.asarray(y_exact), np.asarray(y_old)) < SNR_REQ


def test_agc_chunked_matches_exact():
    x = _agc_signal(20000)
    params = kagc.make_params(alpha=0.01)
    st = kagc.agc_init()
    _, (y_exact, _) = kagc.agc_apply(params, st, jnp.asarray(x, jnp.complex64))
    st = kagc.agc_init()
    _, (y_chunk, _) = kagc.agc_apply_chunked(params, st, jnp.asarray(x, jnp.complex64),
                                             chunk=1024, warmup=2048)
    assert snr_db(np.asarray(y_exact), np.asarray(y_chunk)) > SNR_REQ


# ---------------------------------------------------------------------------
# FreqDem
# ---------------------------------------------------------------------------
def test_freqdem_vs_oracle():
    kd = 4.0
    m = tones(3000, [0.004], complex_out=False)
    phase = 2 * np.pi * kd * np.cumsum(m) / 100
    x = np.exp(1j * (2 * np.pi * 0.0 + phase))
    orc = FreqDemOracle(kd)
    y_ref = orc(x)
    prev = kfd.freqdem_init()
    prev, y1 = kfd.freqdem_apply(jnp.float32(kd), prev, jnp.asarray(x[:777], jnp.complex64))
    _, y2 = kfd.freqdem_apply(jnp.float32(kd), prev, jnp.asarray(x[777:], jnp.complex64))
    y = np.concatenate([np.asarray(y1), np.asarray(y2)])
    assert snr_db(y_ref, y) > SNR_REQ


# ---------------------------------------------------------------------------
# Resampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rate", [0.024, 0.4, 1.0, 2.5])
def test_resamp_vs_oracle(rate):
    m, fc, As, npfb = 7, min(0.45, 0.45 * min(1.0, rate)), 60.0, 64
    fc = max(fc, 1e-3)
    H = firdes.resamp_bank(m, fc, As, npfb)
    n = 2000
    x = noise(n, complex_out=False, seed=11)
    orc = ResampOracle(H, rate)
    y_ref = np.concatenate([orc(x[:701]), orc(x[701:])])
    Hj = jnp.asarray(H, jnp.float32)
    tail = krs.resamp_init(2 * m, jnp.float32)
    tau = 0.0
    ys = []
    for piece in (x[:701], x[701:]):
        n_out, q, frac, tau = krs.plan(tau, len(piece), rate)
        tail, y = krs.resamp_apply(Hj, tail, jnp.asarray(piece, jnp.float32),
                                   jnp.asarray(q), jnp.asarray(frac))
        ys.append(np.asarray(y))
    y = np.concatenate(ys)
    assert len(y) == len(y_ref)
    assert snr_db(y_ref, y) > SNR_REQ


def test_resamp_tone_fidelity():
    """A tone through the resampler must come out at freq/rate' with the
    filter's passband gain: checks the polyphase bank construction itself."""
    rate = 48000.0 / 2000000.0
    m, fc, As, npfb = 13, 0.45 * rate, 60.0, 64
    H = firdes.resamp_bank(m, fc, As, npfb)
    f_in = 0.002  # well inside passband (fc ~ 0.0108)
    n = 200000
    x = tones(n, [f_in], complex_out=False)
    Hj = jnp.asarray(H, jnp.float32)
    tail = krs.resamp_init(2 * m, jnp.float32)
    n_out, q, frac, _ = krs.plan(0.0, n, rate)
    _, y = krs.resamp_apply(Hj, tail, jnp.asarray(x, jnp.float32),
                            jnp.asarray(q), jnp.asarray(frac))
    y = np.asarray(y, dtype=np.float64)
    # skip the filter startup transient
    y = y[100:-10]
    t_out = (np.arange(n_out) / rate)[100:-10]
    # fit the complex amplitude (absorbs passband gain/phase of the
    # anti-alias filter), then demand the residual be tiny: verifies the
    # polyphase bank produces a clean tone at the right frequency
    ph = np.exp(2j * np.pi * f_in * (t_out - m))  # group delay m input samples
    a = np.vdot(ph, y + 0j) / np.vdot(ph, ph)
    ref = 2.0 * (a * ph).real  # real tone = 2 Re(projection)
    assert abs(abs(a) * 2 - 1.0) < 0.05  # passband gain within 5%
    assert snr_db(ref, y) > 55.0


# ---------------------------------------------------------------------------
# PLL
# ---------------------------------------------------------------------------
def test_pll_vs_oracle():
    f = 0.01
    n = 5000
    x = np.exp(2j * np.pi * f * np.arange(n) + 1j * 0.3)
    orc = PllOracle(bandwidth=0.01)
    th_ref = orc.run(x)
    st = kpll.pll_init()
    st, th1 = kpll.pll_carrier_scan(st, jnp.asarray(x[:2000], jnp.complex64), 0.01)
    _, th2 = kpll.pll_carrier_scan(st, jnp.asarray(x[2000:], jnp.complex64), 0.01)
    th = np.concatenate([np.asarray(th1), np.asarray(th2)])
    # compare as phasors (theta wraps differently but e^{j theta} must match)
    assert snr_db(np.exp(1j * th_ref[3000:]), np.exp(1j * th[3000:])) > 40.0
    # and the loop must actually be locked to the carrier
    err = np.angle(x[4000:] * np.exp(-1j * th[4000:]))
    assert np.abs(err).max() < 0.01


def test_pll_chunked_matches_exact():
    f = 0.01
    n = 40000
    rng = np.random.default_rng(12)
    x = np.exp(2j * np.pi * f * np.arange(n) + 1j * 0.3)
    x = x + noise(n, 0.01, seed=13)
    xj = jnp.asarray(x, jnp.complex64)
    _, th_exact = kpll.pll_carrier_scan(kpll.pll_init(), xj, 0.01)
    _, th_chunk = kpll.pll_carrier_scan_chunked(kpll.pll_init(), xj, 0.01,
                                                chunk=2048, warmup=4096)
    a = np.exp(1j * np.asarray(th_exact[8192:]))
    b = np.exp(1j * np.asarray(th_chunk[8192:]))
    assert snr_db(a, b) > SNR_REQ


# ---------------------------------------------------------------------------
# Hilbert
# ---------------------------------------------------------------------------
def test_hilbert_c2r_sideband_split():
    m = 25
    h = firdes.hilbert_fir(m, 60.0)
    hj = jnp.asarray(h, jnp.float32)
    n = 8192
    f = 0.05
    usb = np.exp(2j * np.pi * f * np.arange(n))   # positive-frequency tone
    st = khilb.c2r_init(m)
    _, (lo, up) = khilb.c2r_apply(hj, st, jnp.asarray(usb, jnp.complex64))
    lo, up = np.asarray(lo[4 * m:]), np.asarray(up[4 * m:])
    # upper output carries the tone (amplitude 2), lower rejects it
    assert 10 * np.log10(np.mean(up**2) / np.mean(lo**2)) > 50.0
    ref = 2 * np.cos(2 * np.pi * f * (np.arange(n) - 2 * m))[4 * m:]
    assert snr_db(ref, up) > 50.0


def test_hilbert_interp_decim_roundtrip():
    m = 7
    hb = firdes.halfband_lowpass(m, 60.0)
    hbj = jnp.asarray(hb, jnp.float32)
    n = 4096
    f = 0.05
    x = np.exp(2j * np.pi * f * np.arange(n)) * 0.7
    ist = khilb.interp_init(m)
    _, y = khilb.interp_apply(hbj, ist, jnp.asarray(x, jnp.complex64))
    assert y.shape[0] == 2 * n
    dst = khilb.decim_init(m)
    _, z = khilb.decim_apply(hbj, dst, y)
    z = np.asarray(z)
    # round trip: recover x delayed by the two filters' group delay (2m each
    # at the high rate = 2m total at the low rate)
    d = 2 * m
    ref = x[: n - d]
    assert snr_db(ref, z[d:]) > 50.0


def test_strided_cfir_wide_equals_blocked():
    """The wide single-matmul front end (deep contraction) must
    equal the blocked per-phase formulation it replaces."""
    import jax.numpy as jnp
    from tpudsp.kernels import decimate as kdec

    rng = np.random.default_rng(7)
    C, Kc, Q, nj = 5, 13, 10, 400
    Tre = rng.standard_normal((C, Kc, Q)).astype(np.float32)
    Tim = rng.standard_normal((C, Kc, Q)).astype(np.float32)
    L = (nj + Kc - 1) * Q + 3
    X = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(np.complex64)

    a = np.asarray(kdec.strided_cfir_matmul(jnp.asarray(X), Tre, Tim, Q, nj))
    b = np.asarray(kdec.strided_cfir_matmul_wide(jnp.asarray(X), Tre, Tim, Q, nj))
    assert a.shape == b.shape == (C, nj)
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * np.abs(a).max())


def test_strided_cfir_conv_engine_equals_wide():
    """The conv engine (XLA native strided convolution, the CPU-side
    winner: 2-9x over the matmul forms) must match the wide matmul on
    every wire format: c64, raw i16 (pre-scaled taps), raw u8 (affine
    offset folded into per-channel DC terms)."""
    import jax.numpy as jnp
    from tpudsp.kernels import decimate as kdec

    rng = np.random.default_rng(11)
    C, Kc, Q, nj = 4, 13, 10, 300
    Tre = rng.standard_normal((C, Kc, Q)).astype(np.float32)
    Tim = rng.standard_normal((C, Kc, Q)).astype(np.float32)
    L = (nj + Kc - 1) * Q + 5

    X = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(np.complex64)
    a = np.asarray(kdec.strided_cfir_matmul_wide(jnp.asarray(X), Tre, Tim, Q, nj))
    b = np.asarray(kdec.strided_cfir_conv(jnp.asarray(X), Tre, Tim, Q, nj))
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * np.abs(a).max())

    X16 = rng.integers(-32767, 32768, (L, 2)).astype(np.int16)
    a16 = np.asarray(kdec.strided_cfir_matmul_wide_i16(jnp.asarray(X16), Tre, Tim, Q, nj))
    b16 = np.asarray(kdec.strided_cfir_conv_i16(jnp.asarray(X16), Tre, Tim, Q, nj))
    np.testing.assert_allclose(b16, a16, rtol=0, atol=2e-4 * np.abs(a16).max())

    X8 = rng.integers(0, 256, (L, 2)).astype(np.uint8)
    a8 = np.asarray(kdec.strided_cfir_matmul_wide_u8(jnp.asarray(X8), Tre, Tim, Q, nj))
    b8 = np.asarray(kdec.strided_cfir_conv_u8(jnp.asarray(X8), Tre, Tim, Q, nj))
    np.testing.assert_allclose(b8, a8, rtol=0, atol=2e-4 * np.abs(a8).max())


def test_strided_cfir_dispatcher_routes_by_format(monkeypatch):
    """strided_cfir resolves 'auto' to conv on the CPU backend and
    honors the TPUDSP_CFIR_ENGINE override for both engines."""
    import jax.numpy as jnp
    from tpudsp.kernels import decimate as kdec

    assert kdec.cfir_engine("auto") == "conv"  # tests force the CPU backend
    monkeypatch.setenv("TPUDSP_CFIR_ENGINE", "wide")
    assert kdec.cfir_engine("auto") == "wide"
    monkeypatch.delenv("TPUDSP_CFIR_ENGINE")

    rng = np.random.default_rng(12)
    C, Kc, Q, nj = 2, 3, 10, 64
    Tre = rng.standard_normal((C, Kc, Q)).astype(np.float32)
    Tim = rng.standard_normal((C, Kc, Q)).astype(np.float32)
    L = (nj + Kc - 1) * Q
    X = (rng.standard_normal(L) + 1j * rng.standard_normal(L)).astype(np.complex64)
    a = np.asarray(kdec.strided_cfir(jnp.asarray(X), Tre, Tim, Q, nj, engine="wide"))
    b = np.asarray(kdec.strided_cfir(jnp.asarray(X), Tre, Tim, Q, nj, engine="conv"))
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * np.abs(a).max())
    with pytest.raises(ValueError):
        kdec.cfir_engine("nope")


def test_first_order_blocked_mc_equals_vmapped():
    """The multi-channel column scan (row-major (N, C), the channelized
    bank's back-end layout) must match the vmapped per-channel blocked
    scan to f32 ulp -- same block algebra and double-float carry; only
    the within-dot accumulation order differs under jit fusion."""
    rng = np.random.default_rng(5)
    n, C = 5000, 7
    x = rng.standard_normal((n, C)).astype(np.float32)
    y0 = rng.standard_normal(C).astype(np.float32)
    b0, a = 0.0005, 0.9995
    last_mc, y_mc = jax.jit(
        lambda y, v: kiir.first_order_apply_blocked_mc(b0, a, y, v))(
            jnp.asarray(y0), jnp.asarray(x))
    _, y_vm = jax.jit(jax.vmap(
        lambda y, v: kiir.first_order_apply_blocked(b0, a, y, v)))(
            jnp.asarray(y0), jnp.asarray(x.T))
    np.testing.assert_allclose(np.asarray(y_mc).T, np.asarray(y_vm),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(last_mc), np.asarray(y_mc)[-1])


def test_patan2_matches_arctan2():
    """The shared polynomial atan2 (kernels/fastmath.py) feeding every
    FM discriminator and PLL error path: ~2e-6 rad of jnp.arctan2
    across all octants, exact 0 at the origin."""
    from tpudsp.kernels.fastmath import patan2
    rng = np.random.default_rng(6)
    y = rng.standard_normal(200_000).astype(np.float32) * 3.0
    x = rng.standard_normal(200_000).astype(np.float32) * 3.0
    a = np.arctan2(y, x)
    b = np.asarray(jax.jit(patan2)(jnp.asarray(y), jnp.asarray(x)))
    assert np.abs(a - b).max() < 5e-6
    assert float(jax.jit(patan2)(jnp.float32(0), jnp.float32(0))) == 0.0


def test_sos_scan_df_vs_oracle_hard_config():
    """Compensated (double-float) scan on the README's cheby2 order-8
    Fc=0.0075 bandpass config: the plain f32 scan floors near 60 dB here
    (near-unit poles), the df scan must clear 120 dB."""
    sos = iirdes.iirdes_sos("cheby2", "lowpass", 8, 0.0075, As=60.0, Ap=0.5)
    x = noise(4096, complex_out=True, seed=1)
    y_ref = SosFilterOracle(sos)(x)
    pdf = kiir.sos_split_df(sos)
    st = kiir.sos_init(sos, jnp.complex64)
    _, y = jax.jit(kiir.sos_apply_df)(pdf, st, jnp.asarray(x, jnp.complex64))
    assert snr_db(y_ref, np.asarray(y)) > 120.0


def test_sos_scan_df_block_invariance():
    sos = iirdes.iirdes_sos("cheby2", "lowpass", 8, Fc=0.0075, As=60.0)
    pdf = kiir.sos_split_df(sos)
    x = noise(3000, complex_out=True, seed=2).astype(np.complex64)
    st = kiir.sos_init(sos, jnp.complex64)
    _, y_full = kiir.sos_apply_df(pdf, st, jnp.asarray(x))
    st = kiir.sos_init(sos, jnp.complex64)
    parts = []
    for piece in (x[:7], x[7:1000], x[1000:1001], x[1001:]):
        st, yp = kiir.sos_apply_df(pdf, st, jnp.asarray(piece))
        parts.append(np.asarray(yp))
    y_cat = np.concatenate(parts)
    assert snr_db(np.asarray(y_full), y_cat) > 100.0


def test_first_order_df_near_unit_pole():
    """Compensated double-float one-pole scan: the plain f32 scan floors
    at ~86 dB for rho=0.9995 (measured, FIDELITY.md section 1); the df
    scan must clear 110 dB vs a float64 serial loop."""
    import numpy as np
    import jax.numpy as jnp
    from tpudsp.kernels import iir as kiir

    rho = 0.9995
    n = 50000
    rng = np.random.default_rng(0)
    v = (np.sin(2 * np.pi * 0.01 * np.arange(n)) + 1.0
         + 0.01 * rng.standard_normal(n)).astype(np.float32)
    ref = np.empty(n)
    d = 0.0
    for i, x in enumerate(v.astype(np.float64)):
        d = (1.0 - rho) * x + rho * d
        ref[i] = d
    _, y = kiir.first_order_apply_df(
        kiir.first_order_split_df(1.0 - rho, rho), jnp.float32(0.0),
        jnp.asarray(v))
    y = np.asarray(y, np.float64)
    snr = 10 * np.log10(np.mean(ref ** 2) / np.mean((ref - y) ** 2))
    assert snr > 110.0, snr
    # and the plain scan really is the documented floor (sanity on the
    # claim, loose bound)
    _, y32 = kiir.first_order_apply(jnp.float32(1.0 - rho),
                                    jnp.float32(rho), jnp.float32(0.0),
                                    jnp.asarray(v))
    y32 = np.asarray(y32, np.float64)
    snr32 = 10 * np.log10(np.mean(ref ** 2) / np.mean((ref - y32) ** 2))
    assert snr32 < snr - 20.0, (snr32, snr)


def test_first_order_blocked_near_unit_pole():
    """Matmul-blocked first-order scan: >= 115 dB vs the f64
    serial recurrence at the DC tracker's rho = 0.9995 over 50k samples
    (measured 122.9 at L=32; the plain f32 scan floors at ~86), and the
    carried y_last continues an exactly split stream."""
    import numpy as np
    rng = np.random.default_rng(7)
    n = 50_000
    rho = 0.9995
    x = (np.sin(2 * np.pi * 0.02 * np.arange(n)) + 0.3
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    y64 = np.empty(n)
    yp = 0.0
    for k in range(n):
        yp = (1 - rho) * float(x[k]) + rho * yp
        y64[k] = yp
    yl, y = kiir.first_order_apply_blocked(1 - rho, rho, jnp.float32(0.0),
                                           jnp.asarray(x))
    err = y64 - np.asarray(y, np.float64)
    snr = 10 * np.log10(np.sum(y64 ** 2) / np.sum(err ** 2))
    assert snr > 115.0, f"blocked scan SNR {snr:.1f} dB"
    # split-stream continuation: block boundary state carries exactly
    y1l, ya = kiir.first_order_apply_blocked(1 - rho, rho,
                                             jnp.float32(0.0),
                                             jnp.asarray(x[:17_321]))
    y2l, yb = kiir.first_order_apply_blocked(1 - rho, rho, y1l,
                                             jnp.asarray(x[17_321:]))
    ycat = np.concatenate([np.asarray(ya), np.asarray(yb)])
    errs = ycat.astype(np.float64) - y64
    snr_split = 10 * np.log10(np.sum(y64 ** 2) / np.sum(errs ** 2))
    assert snr_split > 110.0, f"split-stream SNR {snr_split:.1f} dB"


def test_first_order_blocked_c64_matches_serial():
    """Complex blocked twin (pilot smoothers): matches the f64 serial
    complex one-pole to the f32 class it replaces."""
    import numpy as np
    rng = np.random.default_rng(8)
    n = 30_000
    rho = 0.999
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    ref = np.empty(n, np.complex128)
    c = 0.2 + 0.1j
    for k in range(n):
        c = (1 - rho) * complex(z[k]) + rho * c
        ref[k] = c
    yl, y = kiir.first_order_apply_blocked_c64(
        1 - rho, rho, jnp.complex64(0.2 + 0.1j), jnp.asarray(z))
    err = ref - np.asarray(y, np.complex128)
    snr = 10 * np.log10(np.sum(np.abs(ref) ** 2)
                        / np.sum(np.abs(err) ** 2))
    assert snr > 90.0, f"blocked c64 SNR {snr:.1f} dB"
    assert abs(complex(yl) - ref[-1]) < 1e-4
