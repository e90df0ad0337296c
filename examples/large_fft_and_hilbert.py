#!/usr/bin/env python
"""Features tour: large-N FFT, odd-hop mel, analytic signal.

Runs on whatever jax.devices() provides (GPU or CPU, same code paths).
Usage: python examples/large_fft_and_hilbert.py
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from godsp_tpu import fft, spectral
from godsp_tpu.models import mel_spectrogram
from godsp_tpu.utils import to_host


def main() -> None:
    rng = np.random.default_rng(0)

    # 1) The reference's benchmark workload: one 2^20-point complex FFT
    #    (fft/fft_test.go:262-280), through the four-step path.
    n = 1 << 20
    z = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    Z = to_host(fft.fft(z))
    print(f"2^20 FFT: bins {Z.shape}, DC {Z[0]:.3f}")

    # 2) Welch PSD with the 10 ms audio hop (stride 160 =
    #    nfft 1024 - noverlap 864).
    fs = 16000.0
    sig = np.sin(2 * np.pi * 440.0 * np.arange(1 << 18) / fs).astype(np.float32)
    pxx, freqs = spectral.pwelch(
        sig, fs, spectral.PwelchOptions(nfft=1024, noverlap=1024 - 160)
    )
    peak_bin = int(np.argmax(np.asarray(pxx)))
    print(f"pwelch hop=160: peak at {float(freqs[peak_bin]):.1f} Hz (expect 440)")

    # 3) Odd-hop mel front end.
    m = mel_spectrogram(sig, fs, nfft=1024, hop=160, n_mels=40)
    print(f"mel spectrogram: {m.shape} (frames x mels)")

    # 4) Analytic signal: envelope of an AM tone via the Hilbert transform.
    t = np.arange(1 << 14) / fs
    am = (1 + 0.5 * np.sin(2 * np.pi * 5 * t)) * np.cos(2 * np.pi * 1000 * t)
    env = np.abs(to_host(fft.hilbert(am.astype(np.float32))))
    print(f"AM envelope range: [{env[200:-200].min():.3f}, {env[200:-200].max():.3f}] (expect ~[0.5, 1.5])")


if __name__ == "__main__":
    main()
