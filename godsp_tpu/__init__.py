"""godsp_tpu — a DSP framework on JAX/XLA for NVIDIA GPUs.

A from-scratch JAX/XLA re-design with the full capability surface of the
go-dsp reference library (FFT, spectral analysis, window tapers, WAV
ingest), built for accelerators: batched transforms compiled by XLA,
device-mesh sharding, and streaming multi-process Welch PSD.

Packages:
  dsputils  — L0 primitives: conversion, padding, segmentation, compare
  window    — symmetric window tapers
  fft       — 1-D/2-D/N-D FFT (four-step matmul, Bluestein), convolution
  spectral  — Welch PSD, CSD, scipy-convention estimators
  wav       — RIFF/WAVE streaming ingest
  parallel  — mesh sharding, halo exchange, distributed/streaming Pwelch
  models    — end-to-end pipelines (STFT/spectrogram, mel, filters)
  utils     — metrics, profiling, compile cache, float64 oracles
"""

__version__ = "0.1.0"

from godsp_tpu import dsputils, fft, spectral, wav, window  # noqa: F401

__all__ = ["dsputils", "fft", "spectral", "wav", "window", "__version__"]

# scipy.signal.windows-style namespace (godsp_tpu.windows)
from godsp_tpu.window import windows  # noqa: E402,F401
