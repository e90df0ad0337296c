#!/usr/bin/env python
"""Audio-ML front end: WAV -> log-mel spectrogram / MFCC.

The complete pipeline (frame -> window -> FFT -> |.|^2 -> mel filterbank)
runs on the device: batched framing, the four-step FFT, and one
filterbank matmul.

  python examples/audio_frontend.py [file.wav]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import io
import sys

import numpy as np

from godsp_tpu import wav
from godsp_tpu.models import mel_spectrogram, mfcc


def synth():
    fs = 16000
    t = np.arange(fs * 3) / fs
    chirp = np.sin(2 * np.pi * (200 + 1500 * t) * t).astype(np.float32)
    buf = io.BytesIO()
    wav.write_wav(buf, chirp * 0.5, fs)
    return buf.getvalue()


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else synth()
    w = wav.read_wav(src)
    x = w.read_floats(w.samples)
    fs = float(w.sample_rate)

    logmel = np.asarray(
        mel_spectrogram(x, fs, nfft=1024, hop=256, n_mels=80, log=True)
    )
    feats = np.asarray(mfcc(x, fs, n_mfcc=13, nfft=1024, hop=256))
    print(f"{len(x)} samples @ {fs:.0f} Hz")
    print(f"log-mel: {logmel.shape}  range [{logmel.min():.1f}, {logmel.max():.1f}]")
    print(f"mfcc:    {feats.shape}")
    # a rising chirp shows mel-band energy moving upward over time
    band_peak = logmel.argmax(axis=1)
    print("mel peak band (first/last 5 frames):", band_peak[:5], band_peak[-5:])


if __name__ == "__main__":
    main()
