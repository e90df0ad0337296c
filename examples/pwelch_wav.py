#!/usr/bin/env python
"""Welch PSD of a WAV file — one-shot and streaming.

Usage: python examples/pwelch_wav.py [file.wav]
Falls back to a synthesized two-tone WAV when no file is given.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import io
import sys

import numpy as np

from godsp_tpu import spectral, wav
from godsp_tpu.models import wav_psd


def synth_wav(fs=8000, seconds=5.0):
    t = np.arange(int(fs * seconds)) / fs
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1000 * t)
    buf = io.BytesIO()
    wav.write_wav(buf, sig.astype(np.float32), fs)
    return buf.getvalue()


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else synth_wav()
    opts = spectral.PwelchOptions(nfft=1024, noverlap=512)

    # Streaming pipeline: blocks -> sharded device step -> (Pxx, freqs).
    res = wav_psd(src, opts, block_size=1 << 18)
    peak = res.freqs[int(np.argmax(res.pxx[1:])) + 1]  # skip DC
    print(f"samples={res.samples} fs={res.sample_rate}")
    print(f"peak at {peak:.1f} Hz")
    print("metrics:", res.metrics_json)


if __name__ == "__main__":
    main()
