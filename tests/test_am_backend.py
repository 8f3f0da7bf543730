"""Fused AM back end: exact combined scan vs the composed XLA stages, and
the Pallas feedback-core kernel vs the exact scan (interpret mode on the
CPU; tests/test_gpu_route.py compiles it for the card)."""

import numpy as np
import jax
import jax.numpy as jnp

from tpudsp.kernels import agc as kagc
from tpudsp.kernels import am_backend as kab
from tpudsp.kernels import iir as kiir
from tpudsp.pallas.am_backend_scan import front_chunked_pallas
from tests.util import snr_db


def _signal(n=40000, carrier_freq=0.002):
    t = np.arange(n)
    m = np.sin(2 * np.pi * 0.02 * t)
    return ((1 + 0.5 * m) * 0.3
            * np.exp(2j * np.pi * carrier_freq * t)).astype(np.complex64)


def _params(carrier=True):
    agcp = kagc.make_params(alpha=0.01, scale=0.01)
    return kab.make_params(agcp, 0.5, 0.05, 0.95, carrier=carrier)


def _kernel_back_end(p, x, chunk, warmup):
    """Feedback core in the kernel, then the exact linear tail (DC tracker
    + de-emphasis): the combined back end, 1 stream."""
    st = jax.tree.map(lambda v: jnp.asarray(v)[None],
                      kab.FrontState(kagc.agc_init(),
                                     kab.PllState(jnp.float32(0.0),
                                                  jnp.float32(0.0))))
    _, (vr, _) = front_chunked_pallas(p, st, x[None, :], chunk=chunk,
                                      warmup=warmup)
    vr = vr[0]
    _, dc = kiir.first_order_apply(1.0 - p.dc_rho, p.dc_rho,
                                   jnp.float32(0.0), vr)
    audio = (vr - dc * p.use_dc) * p.inv_mod
    _, pcm = kiir.first_order_apply(p.deemph_b0, p.deemph_a,
                                    jnp.float32(0.0), audio)
    return pcm


def test_exact_combined_matches_composed_stages():
    """The combined step must equal AGC -> PLL demod -> DC -> deemph run
    as separate exact kernels."""
    from tpudsp.kernels import ampmodem as kam
    x = jnp.asarray(_signal())
    p = _params()
    st = kab.init_state()
    _, (pcm_comb, modes_comb) = kab.am_backend_exact(p, st, x)

    agc_st, (z, modes) = kagc.agc_apply(p.agc, kagc.agc_init(), x)
    am_st, audio = kam.ampdemod_apply(kam.ampdemod_init(), z,
                                      jnp.zeros((1,), jnp.float32),
                                      jnp.float32(0.5), "dsb", True,
                                      exact_pll=True)
    _, pcm = kiir.first_order_apply(jnp.float32(0.05), jnp.float32(0.95),
                                    jnp.float32(0.0), audio)
    assert snr_db(np.asarray(pcm), np.asarray(pcm_comb)) > 65.0
    np.testing.assert_array_equal(np.asarray(modes), np.asarray(modes_comb))


def test_pallas_fused_matches_exact():
    x = jnp.asarray(_signal(40000))
    p = _params()
    st = kab.init_state()
    _, (pcm_exact, _) = kab.am_backend_exact(p, st, x)
    pcm_pal = _kernel_back_end(p, x, chunk=4096, warmup=4096)
    settle = 8000
    assert snr_db(np.asarray(pcm_exact)[settle:],
                  np.asarray(pcm_pal)[settle:]) > 60.0


def test_chain_pallas_backend_matches_xla():
    """AMReceiver(backend='pallas') must reproduce the XLA back end."""
    from tpudsp.chains import AMConfig, AMReceiver
    cfg = AMConfig()
    n = 500_000
    t = np.arange(n)
    iq = ((1 + 0.5 * np.sin(2 * np.pi * 1000 / 2e6 * t)) * 0.3
          * np.exp(2j * np.pi * 200 / 2e6 * t)).astype(np.complex64)
    rx_x = AMReceiver(cfg, block_len=n, plan="fused", exact=False)
    rx_p = AMReceiver(cfg, block_len=n, plan="fused", exact=False,
                      backend="pallas")
    yx = np.asarray(rx_x(iq))
    yp = np.asarray(rx_p(iq))
    assert snr_db(yx[3000:], yp[3000:]) > 65.0


def test_front_chunked_matches_exact():
    """XLA warmup-chunk front (AGC+PLL) vs the exact sequential front."""
    x = jnp.asarray(_signal(30000))
    p = _params()
    st = kab.FrontState(kagc.agc_init(),
                        kab.PllState(jnp.float32(0.0), jnp.float32(0.0)))
    _, (vr_exact, _) = kab.front_exact(p, st, x)
    _, (vr_ch, _) = kab.front_chunked(p, st, x, chunk=1024, warmup=4096)
    settle = 8000
    assert snr_db(np.asarray(vr_exact)[settle:],
                  np.asarray(vr_ch)[settle:]) > 60.0


def test_front_chunked_pallas_batched_matches_exact():
    """Batched (C, L) Pallas front: every stream matches its own exact
    front scan (interpret mode; distinct carriers + message rates, and an
    L that is NOT a multiple of the chunk to exercise the pad fixup)."""
    C, L = 3, 30000 - 128
    xs = np.stack([_signal(L, carrier_freq=0.001 * (c + 1)) for c in range(C)])
    p = _params()
    st = kab.FrontState(
        agc=jax.tree.map(lambda v: jnp.broadcast_to(v, (C,)), kagc.agc_init()),
        pll=kab.PllState(jnp.zeros((C,), jnp.float32),
                         jnp.zeros((C,), jnp.float32)))
    front, (vr, modes) = front_chunked_pallas(p, st, jnp.asarray(xs),
                                              chunk=4096, warmup=4096)
    settle = 8000
    st1 = kab.FrontState(kagc.agc_init(),
                         kab.PllState(jnp.float32(0.0), jnp.float32(0.0)))
    for c in range(C):
        fe, (vre, _) = kab.front_exact(p, st1, jnp.asarray(xs[c]))
        assert snr_db(np.asarray(vre)[settle:],
                      np.asarray(vr)[c, settle:]) > 60.0, c
        # carried state must match the exact scan's per stream
        np.testing.assert_allclose(np.asarray(front.pll.theta[c]),
                                   np.asarray(fe.pll.theta), atol=2e-2)
        np.testing.assert_allclose(np.asarray(front.agc.g[c]),
                                   np.asarray(fe.agc.g), rtol=2e-3)


def test_pallas_fused_no_carrier():
    x = jnp.asarray(_signal(20000, carrier_freq=0.0))
    p = _params(carrier=False)
    st = kab.init_state()
    _, (pcm_exact, _) = kab.am_backend_exact(p, st, x)
    pcm_pal = _kernel_back_end(p, x, chunk=2048, warmup=2048)
    settle = 4000
    assert snr_db(np.asarray(pcm_exact)[settle:],
                  np.asarray(pcm_pal)[settle:]) > 60.0
