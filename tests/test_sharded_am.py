"""Time-sharded single-channel AM receiver (parallel/am.py): the BASELINE
config-1 chain sharded over the time axis of a CPU mesh (SURVEY.md
section 4 test class 4) must match the single-chip receivers, including
across block boundaries (stream carries through the mesh)."""

import numpy as np
import pytest

from tpudsp.chains import AMConfig, AMReceiver
from tpudsp.parallel import ShardedAMReceiver, make_mesh
from tests.util import snr_db


def _am_iq(n, fs=2_000_000.0, f_msg=1000.0, carrier_freq=300.0):
    t = np.arange(n)
    m = np.sin(2 * np.pi * f_msg / fs * t)
    return ((1 + 0.5 * m) * 0.3
            * np.exp(2j * np.pi * carrier_freq / fs * t)).astype(np.complex64)


@pytest.mark.parametrize("t_shards", [8, 4])
def test_sharded_am_matches_time1(t_shards):
    """(1, T) mesh vs (1, 1) mesh: same formulation, so the only
    difference is the warmup-halo entry-state approximation at shard
    boundaries -- must agree to >= 80 dB, streamed over two blocks."""
    n = 2_000_000  # local audio slice must cover the loop warmup window
    iq = _am_iq(2 * n)
    cfg = AMConfig()
    rx1 = ShardedAMReceiver(cfg, make_mesh(1, 1), block_len=n)
    rxT = ShardedAMReceiver(cfg, make_mesh(1, t_shards), block_len=n)
    y1 = np.concatenate([np.asarray(rx1(iq[:n])), np.asarray(rx1(iq[n:]))])
    yT = np.concatenate([np.asarray(rxT(iq[:n])), np.asarray(rxT(iq[n:]))])
    assert y1.shape == yT.shape == (int(2 * n * cfg.rate),)
    assert snr_db(y1[200:], yT[200:]) > 80.0


def test_sharded_am_matches_amreceiver():
    """vs the single-chip AMReceiver with exact scans: the sharded
    receiver uses the combined AGC+PLL step (kernels/am_backend.py),
    pinned at >= 65 dB against the composed stages -- require 55 dB
    here end to end, message recovery on both."""
    n = 2_000_000
    iq = _am_iq(n)
    cfg = AMConfig()
    ref = AMReceiver(cfg, block_len=n, exact=True)
    y_ref = np.asarray(ref(iq))
    rx = ShardedAMReceiver(cfg, make_mesh(1, 8), block_len=n)
    y = np.asarray(rx(iq))
    assert y.shape == y_ref.shape
    settle = len(y) // 4
    assert snr_db(y_ref[settle:], y[settle:]) > 55.0
    # and the audio is the 1 kHz message
    tail = y[settle:]
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    f = np.fft.rfftfreq(len(tail), 1 / 48000.0)
    assert abs(f[np.argmax(spec[3:]) + 3] - 1000.0) < 25.0


def test_sharded_am_rejects_undersized_blocks():
    """A local audio slice shorter than the loop warmup window cannot
    re-derive entry states to spec -- the class must refuse it."""
    with pytest.raises(ValueError, match="warmup"):
        ShardedAMReceiver(AMConfig(), make_mesh(1, 8), block_len=500_000)


@pytest.mark.parametrize("fmt", ["i16", "u8"])
def test_sharded_am_wire_format_matches_converted(fmt):
    """ShardedAMReceiver(input_format='i16'/'u8'): the kf-sample input
    halo rides the ppermute at wire width and the conversion (plus u8's
    per-phase DC subtraction) happens inside each shard's fused front
    matmul; must match the c64 sharded receiver on converted input,
    streamed across blocks."""
    n = 2_000_000
    iq = _am_iq(2 * n)
    if fmt == "i16":
        w = np.stack([np.round(iq.real * 32767 * 0.5),
                      np.round(iq.imag * 32767 * 0.5)],
                     axis=1).astype(np.int16)
        c64 = ((w[:, 0] + 1j * w[:, 1]) / 32767.0).astype(np.complex64)
    else:
        w = np.stack([np.round(iq.real * 127.5 * 0.9 + 127.5),
                      np.round(iq.imag * 127.5 * 0.9 + 127.5)],
                     axis=1).clip(0, 255).astype(np.uint8)
        c64 = ((w[:, 0] - 127.5) / 127.5
               + 1j * (w[:, 1] - 127.5) / 127.5).astype(np.complex64)
    cfg = AMConfig()
    rx_c = ShardedAMReceiver(cfg, make_mesh(1, 8), block_len=n)
    rx_w = ShardedAMReceiver(cfg, make_mesh(1, 8), block_len=n,
                             input_format=fmt)
    # u8 block 0 carries the documented half-LSB tail-init transient
    floors = (50.0, 85.0) if fmt == "u8" else (85.0, 85.0)
    for b, floor in enumerate(floors):
        y_c = np.asarray(rx_c(c64[b * n:(b + 1) * n]))
        y_w = np.asarray(rx_w(w[b * n:(b + 1) * n]))
        got = snr_db(y_c, y_w)
        assert got > floor, (fmt, b, got)
