#!/usr/bin/env python
"""Throughput benchmark: IQ samples/s through the BASELINE receiver chains
on one GPU.

    python bench.py            config 1 (the AM chain) and two stage rows
    python bench.py --all      also BASELINE configs 2-5
    python bench.py --cpu      run on the CPU instead (a rehearsal; its
                               line says platform "cpu" and has no peak)

Without --cpu the run fails unless JAX's first device is a GPU. One
process measures on jax.devices()[0]: each row builds its chain, runs
one step to compile, then times STEPS steps one by one, each ending in
block_until_ready, carrying the chain state from step to step. A row
reports the median, best and worst step, samples/s at the median, and
the input bytes it reads once (the wire format's bytes per sample)
against the card's peak device-memory rate.

Prints exactly ONE JSON line on stdout: the config-1 headline (the
fastest config-1 row), vs_baseline against the reference's implied
2 Msps (BASELINE.md), the device, the card's name and power limit, and
every row. Progress goes to stderr. A failed row makes the exit code
non-zero.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

REFERENCE_BASELINE_SPS = 2_000_000.0  # BASELINE.md reference-implied
STEPS = 7

# Published peaks, dense, without sparsity (NVIDIA H100 Tensor Core GPU
# data sheet), keyed by jax's device_kind. At the card's full power
# limit; nvidia-smi's power.limit is printed beside every result.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {   # SXM5
        "hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12, "f32_flops_per_s": 67e12},
    "NVIDIA H100 PCIe": {
        "hbm_bytes_per_s": 2.0e12, "bf16_flops_per_s": 756e12,
        "tf32_flops_per_s": 378e12, "f32_flops_per_s": 51e12},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def peaks_for(device_kind: str) -> dict:
    """The published peaks of a device kind; an unknown kind is an error,
    never an assumed peak."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {device_kind!r}"
                       f"; add them to bench.PEAKS with their source")
    return PEAKS[device_kind]


def time_steps(step, params, state, x, steps: int = STEPS):
    """Compile + STEPS timed steps of step(params, state, x) -> (state,
    out), state carried. Returns (compile_s, sorted step times, out)."""
    import jax
    t0 = time.perf_counter()
    state, out = step(params, state, x)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(params, state, x)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return compile_s, sorted(times), out


def measure(name, config, step, params, state, x, bytes_per_sample,
            hbm_peak):
    import numpy as np
    import jax
    n = x.shape[0]
    compile_s, times, out = time_steps(jax.jit(step), params, state, x)
    median = times[len(times) // 2]
    finite = all(bool(np.isfinite(np.asarray(leaf)).all())
                 for leaf in jax.tree.leaves(out))
    implied = n / median * bytes_per_sample
    row = {
        "name": name, "config": config, "block": int(n),
        "samples_per_s": n / median,
        "ms_per_block_median": median * 1e3,
        "ms_per_block_best": times[0] * 1e3,
        "ms_per_block_worst": times[-1] * 1e3,
        "compile_s": compile_s,
        "input_bytes_per_sample": bytes_per_sample,
        "implied_input_GB_per_s": implied / 1e9,
        "hbm_roofline_frac": implied / hbm_peak if hbm_peak else None,
        "finite": finite,
    }
    log(f"{name}: {row['ms_per_block_median']:.3f} ms median "
        f"({row['ms_per_block_best']:.3f}-{row['ms_per_block_worst']:.3f}), "
        f"{row['samples_per_s'] / 1e6:.1f} Msamp/s, compile {compile_s:.1f} s")
    if not finite:
        raise RuntimeError(f"{name}: non-finite output")
    return row


def _rows(all_configs: bool):
    """(name, config, thunk) for every row; each thunk returns the
    measure() arguments after the name and config."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from tpudsp.chains.am import AMConfig, build as am_build, am_step_fused
    from tpudsp.chains.bank import BankConfig, build as bank_build, bank_step
    from tpudsp.kernels import decimate as kdec

    @partial(jax.jit, static_argnums=(0, 1))
    def noise(n, seed):
        kr, ki = jax.random.split(jax.random.PRNGKey(seed))
        return (0.1 * (jax.random.normal(kr, (n,))
                       + 1j * jax.random.normal(ki, (n,)))).astype(jnp.complex64)

    @partial(jax.jit, static_argnums=(0,))
    def am_signal(n):
        cfg = AMConfig()
        t = jnp.arange(n, dtype=jnp.float32)
        msg = jnp.sin(2 * jnp.pi * 1000.0 / cfg.iq_rate * t)
        ph = 2 * jnp.pi * 200.0 / cfg.iq_rate * t
        return ((1.0 + 0.5 * msg) * 0.3 * jnp.exp(1j * ph)).astype(jnp.complex64)

    @partial(jax.jit, static_argnums=(1,))
    def wire(v, fmt):
        xy = jnp.stack([v.real, v.imag], axis=1)
        if fmt == "i16":
            return jnp.clip(jnp.round(xy * 32767.0), -32767, 32767).astype(jnp.int16)
        return jnp.clip(jnp.round(xy * 127.5 + 127.5), 0, 255).astype(jnp.uint8)

    def as_fmt(v, fmt):
        return v if fmt == "c64" else wire(v, fmt)

    bps = {"c64": 8, "i16": 4, "u8": 2}
    f16 = tuple(float(f) for f in np.linspace(-1e6, 1e6, 16, endpoint=False))
    cfg16 = BankConfig(freqs=f16)

    # config 0: the bank front end alone (one strided complex FIR + NCO
    # rotation, the kernel carrying most of the chains' FLOPs and bytes);
    # a stage row, never the config-1 metric
    def stage(fmt):
        p16, s16 = bank_build(cfg16, fmt)
        K1, D1 = cfg16.taps1, cfg16.decim1

        def stage_step(p, tail, iq):
            X = jnp.concatenate([tail, iq])
            y1 = kdec.strided_cfir(X, p.taps_re, p.taps_im, D1, iq.shape[0] // D1)
            return X[-(K1 - 1):], y1

        n = 2_000_000
        return stage_step, p16, s16.in_tail, as_fmt(am_signal(n), fmt), bps[fmt]

    for fmt in ("c64", "u8"):
        yield f"stage_frontend16_{fmt}", 0, partial(stage, fmt)

    # config 1: the AM chain (fused plan), 2M-sample blocks (1 s of IQ)
    def am(fmt, backend="xla"):
        cfg = AMConfig()
        n = 2_000_000
        params, state, _ = am_build(cfg, n, fmt)
        step = partial(am_step_fused, cfg=cfg, exact=False, backend=backend)
        return step, params, state, as_fmt(am_signal(n), fmt), bps[fmt]

    for fmt in ("c64", "i16", "u8"):
        yield f"am_chain_fused_{fmt}", 1, partial(am, fmt)
    yield "am_chain_fused_pallas", 1, partial(am, "c64", "pallas")
    if not all_configs:
        return

    # config 2: WBFM broadcast at 2.4 Msps, mono and stereo
    n2 = 2_000_000

    def wbfm_mono():
        cfg = BankConfig(freqs=(0.0,), iq_rate=2_400_000.0, demod="fm",
                         decim1=10, decim2=5, kd=75_000.0 / 240_000.0)
        p, s = bank_build(cfg)
        return partial(bank_step, cfg=cfg), p, s, noise(n2, 2), 8

    def wbfm_stereo():
        from tpudsp.chains.wbfm import WBFMStereoReceiver, _stereo_step
        rx = WBFMStereoReceiver(block_len=n2)
        return (partial(_stereo_step, cfg=rx.cfg), rx._params, rx.state,
                noise(n2, 2), 8)

    yield "wbfm_mono", 2, wbfm_mono
    yield "wbfm_stereo", 2, wbfm_stereo

    # config 3: 16-channel bank, 8M-sample blocks
    def bank16(fmt):
        n = 8_000_000
        p, s = bank_build(cfg16, fmt)
        return (partial(bank_step, cfg=cfg16), p, s,
                as_fmt(noise(n, 3), fmt), bps[fmt])

    for fmt in ("c64", "i16", "u8"):
        yield "bank16" + ("" if fmt == "c64" else f"_{fmt}"), 3, partial(bank16, fmt)

    # config 4: 1024-channel channelized bank, 16M-sample blocks
    from tpudsp.chains.channelizer import (
        ChannelizedBankConfig, bank_build as ch_build, bank_step as ch_step)
    ccfg = ChannelizedBankConfig()
    nc = 1024 * 16384

    def channelized(fmt):
        p, s = ch_build(ccfg, fmt)
        return (partial(ch_step, cfg=ccfg), p, s, as_fmt(noise(nc, 4), fmt),
                bps[fmt])

    for fmt in ("c64", "i16", "u8"):
        yield ("channelized_1024ch" + ("" if fmt == "c64" else f"_{fmt}"), 4,
               partial(channelized, fmt))

    # config 5 core: the wideband scanner on a 1-device mesh
    def scanner():
        from tpudsp.parallel import make_mesh
        from tpudsp.parallel.multihost import ShardedScanner
        sc = ShardedScanner(ccfg, make_mesh(1, 1), block_len=nc)
        return (lambda p, st, v: sc._step(p, st, v), sc.params, sc.state,
                noise(nc, 4), 8)

    yield "scanner_1chip", 5, scanner


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import jax
    from tpudsp.utils.gpu import card_line, enable_compile_cache, require_gpu
    if "--cpu" in argv:
        jax.config.update("jax_platforms", "cpu")
        dev, card, hbm_peak = jax.devices()[0], "cpu", None
    else:
        try:
            dev = require_gpu()
        except RuntimeError as e:
            log(f"bench.py: {e}; pass --cpu to rehearse on the CPU")
            return 2
        card = card_line()
        hbm_peak = peaks_for(dev.device_kind)["hbm_bytes_per_s"]
    log(f"device: {dev.platform} {dev.device_kind}; card: {card}; "
        f"compile cache: {enable_compile_cache()}")

    rows, failed = [], []
    for name, config, setup in _rows("--all" in argv):
        try:
            rows.append(measure(name, config, *setup(), hbm_peak=hbm_peak))
        except Exception as e:  # a failed row is recorded; the rest still run
            log(f"{name}: FAILED {type(e).__name__}: {e}")
            failed.append(name)
            rows.append({"name": name, "config": config,
                         "error": f"{type(e).__name__}: {str(e)[:200]}"})
    ok1 = [r for r in rows if r["config"] == 1 and "error" not in r]
    head = max(ok1, key=lambda r: r["samples_per_s"]) if ok1 else None
    print(json.dumps({
        "metric": "am_chain_iq_samples_per_sec",
        "value": head and head["samples_per_s"],
        "unit": "samples/s",
        "variant": head and head["name"],
        "vs_baseline": head and head["samples_per_s"] / REFERENCE_BASELINE_SPS,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "failed_rows": failed,
        "rows": rows,
    }), flush=True)
    return 1 if failed or head is None else 0


if __name__ == "__main__":
    sys.exit(main())
