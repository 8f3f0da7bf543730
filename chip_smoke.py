#!/usr/bin/env python
"""Smoke test of the receiver chains on one GPU, at real sizes.

    python chip_smoke.py           phases 1-5 on one card
    python chip_smoke.py --multi   the four-card sharded paths only

Every phase runs in this one process and prints one JSON line of
findings; a failed check raises, so the script exits non-zero and prints
no result line. The first line is the card's name and power limit, as
nvidia-smi gives them; the last is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Without a GPU the script exits non-zero at once (there is no CPU
fallback). Phases:

1. the reference README chain through tpudsp.compat, on int16 bytes;
2. the flagship AMReceiver (BASELINE config 1) on 2M-sample blocks in
   c64, i16 and u8, against the float64 oracle (>= 100 dB);
3. the served path: MockRTLSDRDriver u8 bytes -> RadioSource ->
   StreamRuntime -> AMReceiver;
4. one steady step of every other chain, with its memory analysis;
5. the Pallas feedback-core kernel against the exact scan, and the AM
   chain's step time with backend='pallas' and 'xla'.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FS_AM = 2_000_000.0


def emit(phase: str, **findings):
    print(json.dumps({"phase": phase, **findings}, default=str), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def snr_db(ref, test):
    import numpy as np
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(test, np.float64)
    return float(10.0 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2),
                                                          1e-300)))


def am_iq(n, fs=FS_AM, f_msg=1000.0, carrier_hz=200.0, n0=0):
    """The AM test signal of tests/test_chain_snr.py, samples [n0, n0+n):
    a 1 kHz tone at 50% modulation on a carrier offset by carrier_hz,
    complex128."""
    import numpy as np
    t = n0 + np.arange(n)
    msg = np.sin(2 * np.pi * f_msg / fs * t)
    return (1.0 + 0.5 * msg) * 0.3 * np.exp(2j * np.pi * carrier_hz / fs * t)


def to_wire(iq, fmt):
    """(N, 2) wire samples and the complex128 values the chain reads."""
    import numpy as np
    xy = np.stack([iq.real, iq.imag], axis=1)
    if fmt == "i16":
        w = np.clip(np.round(xy * 32767), -32767, 32767).astype(np.int16)
        v = w / 32767.0
    else:
        w = np.clip(np.round(xy * 127.5 + 127.5), 0, 255).astype(np.uint8)
        v = (w - 127.5) / 127.5
    return w, v[:, 0] + 1j * v[:, 1]


def tone_hz(pcm, fs):
    import numpy as np
    tail = np.asarray(pcm, np.float64)[len(pcm) // 2:]
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    return float(np.fft.rfftfreq(len(tail), 1.0 / fs)[np.argmax(spec[3:]) + 3])


def steady_ms(fn, n=5):
    """Median wall time of n calls after one warm call, each ending in
    block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[n // 2] * 1e3


# -- phase 1 -----------------------------------------------------------------
def phase_compat(n_blocks: int = 8, block: int = 250_000):
    """The reference README chain (README.md, 'Drop-in API surface'), as a
    user writes it, on bytes_to_iq int16 blocks at 2 Msps."""
    import numpy as np
    import tpudsp.compat as liquiddsp

    iq_rate, pcm_rate = 2_000_000, 48_000
    bandpass = liquiddsp.ComplexIIRFilter(filter_type="cheby2", order=8,
                                          Fc=15000 / iq_rate)
    resample = liquiddsp.ComplexResampler(rate=pcm_rate / iq_rate,
                                          Fc=pcm_rate / iq_rate)
    am = liquiddsp.AmpModem(modulation=0.5, type="dsb", carrier=True)
    agc = liquiddsp.AGC()
    agc.scale = 0.01
    deemph = liquiddsp.DeemphasisFilter(pcm_rate)

    n = n_blocks * block
    raw = np.empty(2 * n, np.int16)
    iq = am_iq(n)
    raw[0::2] = np.clip(np.round(iq.real * 32767), -32767, 32767)
    raw[1::2] = np.clip(np.round(iq.imag * 32767), -32767, 32767)
    t0 = time.perf_counter()
    pcm = []
    for i in range(n_blocks):
        blk = liquiddsp.bytes_to_iq(raw[2 * i * block:2 * (i + 1) * block]
                                    .tobytes())
        pcm.append(np.asarray(deemph(am(agc(resample(bandpass(blk)))))))
    pcm = np.concatenate(pcm)
    wall = time.perf_counter() - t0
    check(np.isfinite(pcm).all(), "compat chain: non-finite audio")
    check(abs(len(pcm) - n * pcm_rate / iq_rate) <= n_blocks,
          f"compat chain: {len(pcm)} PCM samples for {n} IQ samples")
    f = tone_hz(pcm, pcm_rate)
    check(abs(f - 1000.0) < 25.0, f"compat chain: tone at {f} Hz")
    emit("compat_readme_chain", blocks=n_blocks, block=block, iq_in=n,
         pcm_out=len(pcm), ratio=len(pcm) / n, tone_hz=f, wall_s=wall)


# -- phase 2 -----------------------------------------------------------------
def phase_am(block: int = 2_000_000, n_blocks: int = 2,
             bar_db: float = 100.0):
    """AMReceiver (config 1, fused plan) on consecutive blocks, so carried
    state crosses a block boundary, against the float64 oracle over the
    settled region (the bar of tests/test_chain_snr.py)."""
    import numpy as np
    import jax
    from tpudsp.chains import AMConfig, AMReceiver
    from tpudsp.kernels import precision as kp
    from tests.test_chain_snr import oracle_am_chain

    cfg = AMConfig()
    iq = am_iq(n_blocks * block)
    snr, ms = {}, {}
    for fmt in ("c64", "i16", "u8"):
        if fmt == "c64":
            x, v = iq.astype(np.complex64), iq.astype(np.complex64)
        else:
            x, v = to_wire(iq, fmt)
        rx = AMReceiver(cfg, block_len=block, input_format=fmt)
        blocks = [jax.device_put(x[b * block:(b + 1) * block])
                  for b in range(n_blocks)]
        y = np.concatenate([np.asarray(rx(xb)) for xb in blocks])
        check(y.shape == (int(n_blocks * block * cfg.rate),),
              f"AMReceiver {fmt}: output shape {y.shape}")
        y_or = oracle_am_chain(np.asarray(v, np.complex128), cfg)
        settle = len(y) // 2
        snr[fmt] = snr_db(y_or[settle:], y[settle:])
        ms[fmt] = steady_ms(lambda: rx(blocks[0]))
        check(snr[fmt] >= bar_db,
              f"AMReceiver {fmt}: {snr[fmt]:.1f} dB vs oracle < {bar_db}")
    emit("am_receiver", block=block, blocks=n_blocks,
         precision=kp.MATMUL.name, snr_db=snr, bar_db=bar_db,
         step_ms=ms)


# -- phase 3 -----------------------------------------------------------------
def phase_served(block: int = 2_000_000, n_blocks: int = 4):
    """RTL-SDR u8 bytes from the mock driver through RadioSource and
    StreamRuntime into the AM chain."""
    import numpy as np
    from tpudsp.chains import AMConfig, AMReceiver
    from tpudsp.io import MockRTLSDRDriver, RadioSource, StreamRuntime

    cfg = AMConfig()
    total = n_blocks * block

    def render(n0, n):
        return am_iq(n, n0=n0)

    drv = MockRTLSDRDriver(render, total, sample_rate=FS_AM)
    rt = StreamRuntime(AMReceiver(cfg, block_len=block, input_format="u8"),
                       sample_format="uint8_raw", capacity_blocks=2 * n_blocks)
    src = RadioSource(rt)
    t0 = time.perf_counter()
    src.run_async(drv, chunk_bytes=262_144)
    deadline = time.monotonic() + 300
    while src.bytes_delivered < 2 * total and time.monotonic() < deadline:
        time.sleep(0.05)
    src.stop(drain=True)
    audio = [np.asarray(a) for a in rt]
    wall = time.perf_counter() - t0
    stats = src.stats
    check(len(audio) == n_blocks, f"served path: {len(audio)} blocks")
    pcm = np.concatenate(audio)
    check(pcm.shape == (int(total * cfg.rate),),
          f"served path: {pcm.shape} PCM samples")
    check(np.isfinite(pcm).all(), "served path: non-finite audio")
    check(stats["overflow_chunks"] == 0 and stats["dropped_bytes"] == 0,
          f"served path dropped data: {stats}")
    f = tone_hz(pcm, cfg.pcm_rate)
    check(abs(f - 1000.0) < 25.0, f"served path: tone at {f} Hz")
    emit("served_path", blocks=len(audio), pcm_out=len(pcm), tone_hz=f,
         chunks=stats["chunks_delivered"], overflow=stats["overflow_chunks"],
         dropped_bytes=stats["dropped_bytes"], wall_s=wall)


# -- phase 4 -----------------------------------------------------------------
def _fm_iq(n, fs, freqs, dev_hz=25_000.0):
    import numpy as np
    t = np.arange(n)
    out = 0
    for i, f in enumerate(freqs):
        m = np.sin(2 * np.pi * (700.0 + 400.0 * i) / fs * t)
        out = out + np.exp(1j * (2 * np.pi * f / fs * t
                                 + 2 * np.pi * dev_hz / fs * np.cumsum(m)))
    return (0.5 * out / len(freqs)).astype(np.complex64)


def _am_bank_iq(n, fs, freqs):
    import numpy as np
    t = np.arange(n)
    out = 0
    for i, f in enumerate(freqs):
        m = np.sin(2 * np.pi * (900.0 + 500.0 * i) / fs * t)
        out = out + (1 + 0.5 * m) * 0.3 * np.exp(
            2j * np.pi * (f + 20.0 + 5.0 * i) / fs * t)
    return (out / len(freqs)).astype(np.complex64)


def _step_check(name, step, args, want_shape):
    """Compile a chain's jitted step, run it twice (the second is the
    steady step) and check its audio."""
    import numpy as np
    import jax
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    state, out = compiled(*args)
    jax.block_until_ready(out)
    args = (args[0], state) + tuple(args[2:])
    t0 = time.perf_counter()
    _, out = compiled(*args)
    audio = np.asarray(jax.block_until_ready(out[0] if isinstance(out, tuple)
                                             else out))
    step_ms = (time.perf_counter() - t0) * 1e3
    check(audio.shape == want_shape, f"{name}: shape {audio.shape}")
    check(np.isfinite(audio).all(), f"{name}: non-finite audio")
    check(np.abs(audio).max() > 0.0, f"{name}: silent audio")
    return {"shape": list(audio.shape), "step_ms": step_ms,
            "compile_s": compile_s,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
            "output_bytes": getattr(mem, "output_size_in_bytes", None)}


def phase_chains(n_wbfm: int = 2_000_000, n_bank: int = 8_000_000,
                 n_chan: int = 1024 * 16384, nchan: int = 1024):
    """One steady step of WBFM stereo, the 16-channel bank (FM and
    coherent AM), the 1024-channel channelized bank and the scanner on a
    1-device mesh, at the block sizes bench.py uses."""
    import numpy as np
    import jax.numpy as jnp
    from tpudsp.chains import BankConfig, ReceiverBank
    from tpudsp.chains.channelizer import (ChannelizedBank,
                                           ChannelizedBankConfig,
                                           ChannelizerConfig)
    from tpudsp.chains.wbfm import WBFMStereoReceiver
    from tpudsp.parallel import make_mesh
    from tpudsp.parallel.multihost import ShardedScanner

    out = {}
    rx = WBFMStereoReceiver(block_len=n_wbfm)
    x = jnp.asarray(_fm_iq(n_wbfm, 2_400_000.0, (0.0,), dev_hz=75_000.0))
    out["wbfm_stereo"] = _step_check(
        "wbfm_stereo", rx._step, (rx._params, rx.state, x),
        (n_wbfm * 2 // (rx.cfg.decim1 * rx.cfg.decim2), 2))

    f16 = tuple(float(f) for f in np.linspace(-1e6, 1e6, 16, endpoint=False))
    for demod, sig in (("fm", _fm_iq), ("am", _am_bank_iq)):
        cfg = BankConfig(freqs=f16, demod=demod, am_coherent=demod == "am")
        bk = ReceiverBank(cfg, block_len=n_bank)
        x = jnp.asarray(sig(n_bank, cfg.iq_rate, f16[::3]))
        out[f"bank16_{demod}"] = _step_check(
            f"bank16_{demod}", bk._step, (bk.params, bk.state, x),
            (16, n_bank // (cfg.decim1 * cfg.decim2)))

    ccfg = ChannelizedBankConfig(channelizer=ChannelizerConfig(nchan=nchan))
    fs = ccfg.channelizer.iq_rate
    active = (10, 3 * nchan // 10)  # occupied channels
    x = jnp.asarray(_fm_iq(n_chan, fs, tuple(fs * c / nchan for c in active)))
    cb = ChannelizedBank(ccfg, block_len=n_chan)
    out["channelized_1024ch"] = _step_check(
        "channelized_1024ch", cb._step, (cb.params, cb.state, x),
        (nchan, n_chan // nchan))
    sc = ShardedScanner(ccfg, make_mesh(1, 1), block_len=n_chan)
    out["scanner_1dev"] = _step_check(
        "scanner_1dev", sc._step, (sc.params, sc.state, x),
        (nchan, n_chan // nchan))
    emit("chains", **out)


# -- phase 5 -----------------------------------------------------------------
def phase_kernel(am_block: int = 2_000_000, bank_block: int = 8_000_000):
    """The Pallas feedback core (Triton) against the exact scan, run on the
    host CPU device, at config-1 and 16-channel bank widths, timed beside
    its XLA twin (kernels/am_backend.front_chunked); then the AM chain's
    steady step with each back end."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from tpudsp.chains import AMConfig, AMReceiver
    from tpudsp.kernels import agc as kagc, am_backend as kab
    from tpudsp.kernels.ampmodem import PLL_BW
    from tpudsp.kernels.warmup import chunk_for, warmup_for
    from tpudsp.pallas.am_backend_scan import front_chunked_pallas

    cpu = jax.devices("cpu")[0]
    w = warmup_for(agc_alpha=0.01, pll_bw=PLL_BW)
    found = {}
    for label, C, L, scale, fs in (
            ("config1", 1, int(am_block * 0.024), 0.01, 48_000.0),
            ("bank16", 16, bank_block // 10, 1.0, 240_000.0)):
        p = kab.make_params(kagc.make_params(alpha=0.01, scale=scale),
                            1.0, 0.05, 0.95, carrier=True)
        xs = np.stack([am_iq(L, fs=fs, f_msg=700.0 + 150.0 * c,
                             carrier_hz=20.0 + 5.0 * c) * (1.0 + 0.1 * c)
                       for c in range(C)]).astype(np.complex64)
        st = kab.FrontState(
            agc=jax.tree.map(lambda v: jnp.broadcast_to(v, (C,)),
                             kagc.agc_init()),
            pll=kab.PllState(jnp.zeros((C,)), jnp.zeros((C,))))
        kern = jax.jit(lambda s, x: front_chunked_pallas(
            p, s, x, chunk=chunk_for(w), warmup=w))
        t0 = time.perf_counter()
        fr, (vr, _) = kern(st, jnp.asarray(xs))
        vr = np.asarray(jax.block_until_ready(vr))
        first_s = time.perf_counter() - t0
        exact = jax.jit(jax.vmap(lambda s, x: kab.front_exact(p, s, x)))
        fe, (vre, _) = exact(jax.device_put(st, cpu), jax.device_put(xs, cpu))
        vre = np.asarray(vre)
        settle = L // 4
        snr = min(snr_db(vre[c, settle:], vr[c, settle:]) for c in range(C))
        dth = float(np.max(np.abs(np.angle(np.exp(1j * (
            np.asarray(fr.pll.theta, np.float64)
            - np.asarray(fe.pll.theta, np.float64)))))))  # wrapped
        dg = float(np.max(np.abs(np.asarray(fr.agc.g) / np.asarray(fe.agc.g)
                                 - 1.0)))
        check(snr >= 60.0, f"kernel {label}: {snr:.1f} dB vs exact < 60")
        check(dth <= 2e-2 and dg <= 2e-3,
              f"kernel {label}: carried state off (theta {dth}, g {dg})")
        twin = jax.jit(jax.vmap(lambda s, x: kab.front_chunked(
            p, s, x, chunk=chunk_for(w), warmup=w)))
        xd = jnp.asarray(xs)
        found[label] = {"C": C, "L": L, "snr_db": snr, "theta_err": dth,
                        "g_rel_err": dg, "first_call_s": first_s,
                        "kernel_ms": steady_ms(lambda: kern(st, xd)[1][0]),
                        "xla_twin_ms": steady_ms(lambda: twin(st, xd)[1][0])}
    x = jax.device_put(am_iq(am_block).astype(np.complex64))
    for backend in ("xla", "pallas"):
        rx = AMReceiver(AMConfig(), block_len=am_block, backend=backend)
        found[f"am_step_ms_{backend}"] = steady_ms(lambda: rx(x))
    emit("feedback_kernel", **found)


# -- --multi -----------------------------------------------------------------
def phase_multi(n_dev: int = 4, n_bank: int = 8_000_000,
                n_chan: int = 1024 * 16384, nchan: int = 1024,
                am_block: int = 2_000_000):
    """The sharded flagships on an n_dev mesh, each against its
    single-device chain on the same input, to the tolerances of
    tests/test_sharding.py, test_tp_channelizer.py, test_scanner.py and
    test_sharded_am.py; and their outputs must span n_dev devices."""
    import numpy as np
    import jax
    from tpudsp.chains import AMConfig, AMReceiver, BankConfig, ReceiverBank
    from tpudsp.chains.channelizer import (ChannelizedBank,
                                           ChannelizedBankConfig, Channelizer,
                                           ChannelizerConfig)
    from tpudsp.parallel import ShardedAMReceiver, make_mesh
    from tpudsp.parallel.bank import ShardedBank
    from tpudsp.parallel.channelizer import (ShardedChannelizedBank,
                                             ShardedChannelizer)
    from tpudsp.parallel.multihost import ShardedScanner

    check(len(jax.devices()) >= n_dev,
          f"--multi needs {n_dev} devices, have {len(jax.devices())}")
    found = {}

    def spans(a, name):
        devs = {s.device for s in a.addressable_shards}
        check(len(devs) == n_dev and not a.sharding.is_fully_replicated,
              f"{name}: output on {len(devs)} devices")
        return len(devs)

    # channelizer and channelized bank: channel-sharded (two all_to_alls)
    ccfg = ChannelizerConfig(nchan=nchan)
    fs = ccfg.iq_rate
    active = (10, 3 * nchan // 10)  # occupied channels
    x = _fm_iq(n_chan, fs, tuple(fs * c / nchan for c in active))
    mesh_c = make_mesh(n_dev, 1)
    tp = ShardedChannelizer(ccfg, mesh_c, block_len=n_chan)
    Y = tp(x)
    xs = jax.device_put(x, jax.sharding.NamedSharding(
        mesh_c, jax.sharding.PartitionSpec(tp.axis_name)))
    _, Ysh = tp._step(tp.Ht, tp.tw, tp.tail, xs)
    Y_ref = np.asarray(Channelizer(ccfg, block_len=n_chan)(x))
    found["channelizer"] = {"snr_db": snr_db(np.abs(Y_ref), np.abs(Y)),
                            "snr_complex_db": snr_db(
                                np.concatenate([Y_ref.real, Y_ref.imag]),
                                np.concatenate([Y.real, Y.imag])),
                            "devices": spans(Ysh, "ShardedChannelizer")}
    check(found["channelizer"]["snr_complex_db"] > 110.0,
          f"ShardedChannelizer: {found['channelizer']}")

    bcfg = ChannelizedBankConfig(channelizer=ccfg)
    tpb = ShardedChannelizedBank(bcfg, mesh_c, block_len=n_chan)
    a = np.asarray(tpb(x))
    a_ref = np.asarray(ChannelizedBank(bcfg, block_len=n_chan)(x))
    got = min(snr_db(a_ref[c], a[c]) for c in active)
    found["channelized_bank"] = {"snr_db_active": got}
    check(got > 90.0, f"ShardedChannelizedBank: {got:.1f} dB")

    # scanner: time-sharded
    sc = ShardedScanner(bcfg, make_mesh(1, n_dev), block_len=n_chan)
    y = sc(x)
    y_ref = np.asarray(ChannelizedBank(bcfg, block_len=n_chan)(x))
    found["scanner"] = {"snr_db": snr_db(y_ref, np.asarray(y)),
                        "devices": spans(y, "ShardedScanner")}
    check(found["scanner"]["snr_db"] > 80.0, f"ShardedScanner: {found}")

    # bank: FM and coherent AM, time-sharded
    f16 = tuple(float(f) for f in np.linspace(-1e6, 1e6, 16, endpoint=False))
    for demod, sig, floor in (("fm", _fm_iq, 80.0), ("am", _am_bank_iq, 55.0)):
        cfg = BankConfig(freqs=f16, demod=demod, am_coherent=demod == "am")
        xb = sig(n_bank, cfg.iq_rate, f16[::3])
        y_ref = np.asarray(ReceiverBank(cfg, block_len=n_bank)(xb))
        sb = ShardedBank(cfg, make_mesh(1, n_dev), block_len=n_bank)
        y = sb(xb)
        settle = y_ref.shape[1] // 4 if demod == "am" else 0
        occupied = [i for i, f in enumerate(f16) if f in f16[::3]]
        got = snr_db(y_ref[occupied, settle:], np.asarray(y)[occupied, settle:])
        found[f"bank16_{demod}"] = {"snr_db": got,
                                    "devices": spans(y, f"ShardedBank {demod}")}
        check(got > floor, f"ShardedBank {demod}: {got:.1f} dB < {floor}")

    # the flagship AM receiver, time-sharded, vs its 1-device mesh
    iq = am_iq(2 * am_block).astype(np.complex64)
    cfg = AMConfig()
    r1 = ShardedAMReceiver(cfg, make_mesh(1, 1), block_len=am_block)
    rT = ShardedAMReceiver(cfg, make_mesh(1, n_dev), block_len=am_block)
    y1 = np.concatenate([np.asarray(r1(iq[:am_block])),
                         np.asarray(r1(iq[am_block:]))])
    pT = [rT(iq[:am_block]), rT(iq[am_block:])]
    yT = np.concatenate([np.asarray(p) for p in pT])
    yS = np.asarray(AMReceiver(cfg, block_len=2 * am_block)(iq))
    found["am_receiver"] = {"snr_db_vs_1dev": snr_db(y1[200:], yT[200:]),
                            "snr_db_vs_single_chain": snr_db(
                                yS[len(yS) // 4:], yT[len(yT) // 4:]),
                            "devices": spans(pT[1], "ShardedAMReceiver")}
    check(found["am_receiver"]["snr_db_vs_1dev"] > 80.0,
          f"ShardedAMReceiver: {found['am_receiver']}")
    emit("multi", n_dev=n_dev, **found)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import jax
    sys.path.insert(0, ROOT)
    from tpudsp.utils.gpu import card_line, enable_compile_cache, require_gpu
    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    enable_compile_cache()
    if "--multi" in argv:
        phase_multi()
    else:
        for phase in (phase_compat, phase_am, phase_served, phase_chains,
                      phase_kernel):
            phase()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
