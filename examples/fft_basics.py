#!/usr/bin/env python
"""FFT family basics: forward/inverse, real input, convolution, N-D.

Mirrors the reference's README usage and the Lyons two-tone example
(fft/fft_test.go:283-320), on whatever device JAX provides.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from godsp_tpu import dsputils, fft
from godsp_tpu.utils import to_host


def main():
    # Lyons §3.1.1: 1 kHz + 2 kHz tones sampled at 8 kHz, 8 points.
    n = np.arange(8)
    x = np.sin(2 * np.pi * n / 8) + 0.5 * np.sin(2 * np.pi * n / 4 + 3 * np.pi / 4)
    X = to_host(fft.fft_real(x))
    for i, v in enumerate(X):
        mag, ph = abs(v), np.angle(v)
        print(f"X[{i}] mag={mag:.4f} phase={ph / np.pi:+.2f}*pi")

    # Round trip (IFFT normalizes by 1/N — reference convention).
    # On an accelerator the compute dtype is float32, so compare by SNR
    # rather than the reference's 1e-8 float64 tolerance.
    back = to_host(fft.ifft(X))
    print("round-trip SNR:", round(dsputils.snr_db(back.real, x), 1), "dB")

    # Arbitrary length -> Bluestein chirp-z under the hood.
    y = np.random.default_rng(0).normal(size=1000)
    Y = to_host(fft.fft_real(y))
    print("bluestein N=1000 vs numpy SNR:",
          round(dsputils.snr_db(Y, np.fft.fft(y)), 1), "dB")

    # Circular convolution (equal lengths, fft.go:56-58) and a 2-D transform.
    c = to_host(fft.convolve(y[:500], y[500:]))
    print("convolve:", c.shape)
    M = to_host(fft.fft2(np.outer(np.hanning(64), np.hanning(128))))
    print("fft2:", M.shape)


if __name__ == "__main__":
    main()
