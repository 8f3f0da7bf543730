#!/usr/bin/env python
"""SSB voice receiver: a suppressed-carrier upper-sideband signal at
2 Msps, demodulated to 48 kHz audio by the fully block-parallel SSB
chain (chains/ssb.py: fused channel filter + decimate as a matmul ->
chunk-parallel AGC -> Hilbert sideband split; no PLL anywhere), with
rssi telemetry per block and the wrong sideband rejected.

Run: python examples/ssb_receiver.py"""

import sys

import numpy as np

sys.path.insert(0, ".")
from tpudsp.chains.ssb import SSBConfig, SSBReceiver  # noqa: E402


def ssb_signal(n, fs, tones, sideband="usb", amp=0.3):
    """Suppressed-carrier SSB: each audio tone f becomes a single complex
    exponential at +f (usb) or -f (lsb) of the (zero) carrier."""
    t = np.arange(n)
    sgn = 1.0 if sideband == "usb" else -1.0
    x = sum(np.exp(2j * np.pi * sgn * f / fs * t) for f in tones)
    return (amp * x / len(tones)).astype(np.complex64)


def tone_peaks(audio, fs_a, k=2):
    a = audio - audio.mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    freqs = np.fft.rfftfreq(len(a), 1 / fs_a)
    idx = np.argsort(spec)[-k:]
    return sorted(round(float(freqs[i])) for i in idx)


def main():
    fs = 2_000_000.0
    tones = (700.0, 1900.0)  # two-tone voice-band test signal
    cfg = SSBConfig(band="usb")
    rx = SSBReceiver(cfg, block_len=500_000)

    n = 4 * rx.block_len
    iq = ssb_signal(n, fs, tones, "usb")
    audio = []
    for b in range(4):
        audio.append(np.asarray(rx(iq[b * rx.block_len:(b + 1) * rx.block_len])))
        print(f"  block {b}: rssi {float(np.asarray(rx.metrics.rssi)):+.1f} dB")
    audio = np.concatenate(audio)
    got = tone_peaks(audio[len(audio) // 2:], cfg.pcm_rate)
    print(f"audio: {audio.shape[0]} samples at {cfg.pcm_rate:.0f} Hz; "
          f"tones {got} (expect {[int(f) for f in tones]})")
    assert all(abs(g - f) <= 3 for g, f in zip(got, tones)), got

    # the SAME tones on the WRONG sideband must be rejected by the split
    rx2 = SSBReceiver(cfg, block_len=500_000)
    bad = ssb_signal(n, fs, tones, "lsb")
    rej = np.concatenate([np.asarray(rx2(bad[b * rx2.block_len:(b + 1) * rx2.block_len]))
                          for b in range(4)])
    p_good = np.mean(audio[len(audio) // 2:] ** 2)
    p_bad = np.mean(rej[len(rej) // 2:] ** 2)
    print(f"wrong-sideband rejection: {10 * np.log10(p_good / p_bad):.1f} dB")
    assert p_good > 100 * p_bad
    print("SSB receiver: OK")


if __name__ == "__main__":
    main()
