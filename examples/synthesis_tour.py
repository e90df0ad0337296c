#!/usr/bin/env python
"""Synthesis-side tour: ISTFT round-trip, streaming synthesis, Griffin-Lim.

The reference library stops at analysis (spectral/pwelch.go computes a
PSD and discards phase); godsp_tpu completes the loop:

  1. stft -> modify -> istft        (fused IFFT+window+overlap-add kernel)
  2. stream_istft                   (chunked synthesis, carried spill)
  3. griffin_lim                    (phase reconstruction from |STFT|)

  python examples/synthesis_tour.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from godsp_tpu.dsputils import snr_db
from godsp_tpu.models import griffin_lim, istft, stft, stream_istft


def main():
    fs = 16000
    t = np.arange(fs * 2) / fs
    x = (
        np.sin(2 * np.pi * 440.0 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    ).astype(np.float32)
    nfft, hop = 1024, 512

    # 1. Analysis -> synthesis round-trip (least-squares overlap-add).
    s = stft(x, nfft, hop=hop)
    y = np.asarray(istft(s, nfft, hop=hop))
    span = len(y)  # frames cover [0, span); the tail remainder is dropped
    print(f"istft round-trip SNR: {snr_db(y[1:-1], x[1 : span - 1]):.1f} dB")

    # 2. Spectral gate, then streaming synthesis in 4 chunks: the
    #    concatenated blocks + coda equal the one-shot inverse exactly.
    from godsp_tpu.utils import to_host

    mag = np.abs(to_host(s))
    thresh = 0.1 * mag.max()
    gated = np.where(mag > thresh, to_host(s), 0.0)
    F = gated.shape[0]
    q = F // 4
    chunks = [gated[i : i + q] for i in range(0, q * 4, q)]
    if q * 4 < F:
        chunks.append(gated[q * 4 :])
    blocks = list(stream_istft(chunks, nfft, hop=hop))
    y_stream = np.concatenate([np.asarray(b) for b in blocks], axis=-1)
    y_once = np.asarray(istft(gated, nfft, hop=hop))
    print(
        f"streaming == one-shot: {snr_db(y_stream, y_once):.1f} dB "
        f"({len(blocks)} blocks)"
    )

    # 3. Griffin-Lim: throw the phase away, get a signal back whose
    #    spectrogram matches.
    y_gl = np.asarray(griffin_lim(mag, nfft, hop=hop, n_iter=32))
    mag_gl = np.abs(to_host(stft(y_gl, nfft, hop=hop)))
    rel = np.linalg.norm(mag_gl - mag) / np.linalg.norm(mag)
    print(f"griffin-lim spectral mismatch after 32 iters: {rel:.3%}")


if __name__ == "__main__":
    main()
