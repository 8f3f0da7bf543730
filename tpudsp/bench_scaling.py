"""Scaling-efficiency harness (SURVEY.md section 4 class 5; BASELINE
target: >= 80% efficiency at N >= 2 hosts).

Measures every sharded flagship at every power-of-two shard count the
available devices allow, against its own single-device baseline:

    efficiency(N) = throughput(N) / (N * throughput(1))

Flagships covered (one row each per N):
  - bank:        time-sharded 16-channel receiver bank (ShardedBank,
                 ppermute input halo)
  - am:          time-sharded single-channel AM receiver (config 1)
  - scanner:     time-sharded channelize+demod (config 5 core)
  - tp:          channel-sharded distributed-FFT channelizer (TP analog)
  - pipeline:    2-stage pipelined AM receiver (throughput at depth 2)

On the GPUs of one host the collectives run over NVLink; on a virtual
CPU mesh (--platform cpu with XLA_FLAGS=--xla_force_host_platform_device_count=N)
wall-clock efficiency reflects host scheduling, not any interconnect,
and every row says so. Run: python -m tpudsp.bench_scaling [nchan]
[block_exp] [--only bank,am,scanner,tp,pipeline] [--json PATH]

With --json, every row is also written to a machine-readable file, each
row carrying the platform and its caveat so a CPU-mesh number can never
be mistaken for a card one.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _rate(step, iters: int = 5):
    import jax
    jax.block_until_ready(step())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step()
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def _noise(n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.1
            ).astype(np.complex64)


def measure_bank(n_time: int, nchan: int, block: int, iters: int = 5):
    from tpudsp.chains.bank import BankConfig
    from tpudsp.parallel import make_mesh
    from tpudsp.parallel.bank import ShardedBank

    cfg = BankConfig(
        freqs=tuple(float(f) for f in
                    np.linspace(-1e6, 1e6, nchan, endpoint=False)))
    bank = ShardedBank(cfg, make_mesh(1, n_time), block_len=block)
    iq = _noise(block)
    return block * iters / _rate(lambda: bank(iq), iters)


def measure_am(n_time: int, block: int, iters: int = 5):
    from tpudsp.chains.am import AMConfig
    from tpudsp.parallel import ShardedAMReceiver, make_mesh

    rx = ShardedAMReceiver(AMConfig(), make_mesh(1, n_time), block_len=block)
    iq = _noise(block, seed=1)
    return block * iters / _rate(lambda: rx(iq), iters)


def measure_scanner(n_time: int, block: int, iters: int = 5):
    from tpudsp.chains.channelizer import (ChannelizedBankConfig,
                                           ChannelizerConfig)
    from tpudsp.parallel import make_mesh
    from tpudsp.parallel.multihost import ShardedScanner

    cfg = ChannelizedBankConfig(
        channelizer=ChannelizerConfig(nchan=256, taps_per_branch=8))
    sc = ShardedScanner(cfg, make_mesh(1, n_time), block_len=block)
    iq = _noise(block, seed=2)
    return block * iters / _rate(lambda: sc(iq), iters)


def measure_tp(n_chan_shards: int, block: int, iters: int = 5):
    from tpudsp.chains.channelizer import ChannelizerConfig
    from tpudsp.parallel import make_mesh
    from tpudsp.parallel.channelizer import ShardedChannelizer

    cfg = ChannelizerConfig(nchan=1024, taps_per_branch=8)
    ch = ShardedChannelizer(cfg, make_mesh(n_chan_shards, 1),
                            block_len=block)
    iq = _noise(block, seed=3)
    return block * iters / _rate(lambda: ch(iq), iters)


def measure_pipeline(block: int, iters: int = 5):
    """2-stage PP throughput (fixed depth; reported as absolute rate and
    vs the single-device AMReceiver)."""
    from tpudsp.chains.am import AMConfig, AMReceiver
    from tpudsp.parallel.pipeline import PipelinedAMReceiver

    iq = _noise(block, seed=4)
    rx1 = AMReceiver(AMConfig(), block_len=block)
    sps1 = block * iters / _rate(lambda: rx1(iq), iters)
    pp = PipelinedAMReceiver(AMConfig(), block_len=block)
    pp(iq)  # fill
    sps2 = block * iters / _rate(lambda: pp(iq), iters)
    return sps1, sps2


def main():
    import jax
    # --platform cpu: run on the (virtual) CPU mesh instead of the cards
    if "--platform" in sys.argv:
        jax.config.update("jax_platforms",
                          sys.argv[sys.argv.index("--platform") + 1])
    # positionals = argv minus flags and their values
    flag_vals = {sys.argv.index(f) + 1
                 for f in ("--platform", "--only", "--json")
                 if f in sys.argv}
    args = [a for i, a in enumerate(sys.argv) if i > 0
            and not a.startswith("--") and i not in flag_vals]
    nchan = int(args[0]) if len(args) > 0 else 16
    block0 = 1 << (int(args[1]) if len(args) > 1 else 20)
    only = None
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    json_path = (sys.argv[sys.argv.index("--json") + 1]
                 if "--json" in sys.argv else None)

    def want(name):
        return only is None or name in only

    ndev = len(jax.devices())
    plat = jax.devices()[0].platform
    caveat = {"gpu": "NVLink between the cards of one host",
              "cpu": "virtual CPU mesh: efficiency reflects the collective/"
                     "halo communication STRUCTURE under host scheduling, "
                     "not any interconnect"}[plat]
    print(f"devices: {ndev} x {jax.devices()[0].device_kind} ({caveat})")
    rows = []

    def emit(row):
        rows.append(dict(row, platform=plat,
                         device_kind=str(jax.devices()[0].device_kind),
                         n_devices=ndev, caveat=caveat))
        if json_path:
            tmp = json_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rows, f, indent=1)
            import os
            os.replace(tmp, json_path)

    for name, fn, quant in (
            ("bank", lambda n, b: measure_bank(n, nchan, b), 50),
            ("am", measure_am, 125),
            ("scanner", measure_scanner, 256)):
        if not want(name):
            continue
        base = None
        n = 1
        while n <= ndev:
            block = block0 - block0 % (quant * n)
            try:
                sps = fn(n, block)
            except (ValueError, NotImplementedError) as e:
                print(f"{name} shards={n}: skipped ({e})")
                emit({"flagship": name, "shards": n, "skipped": str(e)})
                n *= 2
                continue
            if base is None:
                base = sps
            eff = sps / (n * base)
            print(f"{name} time_shards={n}: {sps/1e9:.3f} Gsamp/s, "
                  f"efficiency vs 1-shard: {eff*100:.1f}%")
            emit({"flagship": name, "axis": "time",
                  "shards": n, "block": block,
                  "samples_per_s": round(sps, 1),
                  "efficiency_vs_1shard": round(eff, 4)})
            n *= 2

    if want("tp"):
        base = None
        n = 1
        while n <= ndev:
            block = 1024 * 8 * n * max(1, block0 // (1024 * 64))
            sps = measure_tp(n, block)
            if base is None:
                base = sps
            eff = sps / (n * base)
            print(f"tp chan_shards={n}: {sps/1e9:.3f} Gsamp/s, "
                  f"efficiency vs 1-shard: {eff*100:.1f}%")
            emit({"flagship": "tp", "axis": "channel", "shards": n,
                  "block": block, "samples_per_s": round(sps, 1),
                  "efficiency_vs_1shard": round(eff, 4)})
            n *= 2

    if want("pipeline") and ndev >= 2:
        block = block0 - block0 % 125000
        if block:
            sps1, sps2 = measure_pipeline(block)
            print(f"pipeline stages=2: {sps2/1e9:.3f} Gsamp/s "
                  f"(single-device chain {sps1/1e9:.3f}; ratio "
                  f"{sps2/sps1*100:.1f}%)")
            emit({"flagship": "pipeline", "axis": "stage", "shards": 2,
                  "block": block, "samples_per_s": round(sps2, 1),
                  "single_device_samples_per_s": round(sps1, 1),
                  "ratio_vs_single": round(sps2 / sps1, 4)})


if __name__ == "__main__":
    main()
