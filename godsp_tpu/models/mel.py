"""Mel-scale features: filterbank, log-mel spectrogram, MFCC.

The standard audio-ML front end, built on the framework's batched
spectrogram and the FFT-based DCT (fft/_dct_impl.py): power spectrogram
-> mel filterbank matmul -> log -> DCT-II.  HTK mel scale (2595 log10(1 + f/700)); triangular filters with
optional Slaney area normalization.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import default_float
from godsp_tpu.fft._dct_impl import dct
from godsp_tpu.models._stft_impl import WindowSpec, spectrogram

__all__ = ["mel_filterbank", "mel_spectrogram", "mfcc", "stream_mel"]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@lru_cache(maxsize=None)
def _filterbank_np(
    n_mels: int, nfft: int, fs: float, fmin: float, fmax: float, norm: Optional[str]
) -> np.ndarray:
    """(n_mels, nfft//2 + 1) float64 triangular mel filterbank."""
    if n_mels < 1:
        raise ValueError("n_mels must be >= 1")
    if not 0.0 <= fmin < fmax <= fs / 2.0 + 1e-9:
        raise ValueError(f"need 0 <= fmin < fmax <= fs/2, got [{fmin}, {fmax}]")
    lp = nfft // 2 + 1
    freqs = np.arange(lp, dtype=np.float64) * (fs / nfft)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)  # (n_mels + 2,) band edges

    fb = np.zeros((n_mels, lp), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-12)
        down = (hi - freqs) / max(hi - ctr, 1e-12)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":  # area-normalize each triangle
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unknown norm: {norm}")
    return fb


def mel_filterbank(
    n_mels: int,
    nfft: int,
    fs: float,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = None,
) -> jax.Array:
    """(n_mels, nfft//2 + 1) triangular mel filterbank (HTK mel scale;
    norm="slaney" area-normalizes each filter)."""
    fmax = float(fs) / 2.0 if fmax is None else float(fmax)
    fb = _filterbank_np(int(n_mels), int(nfft), float(fs), float(fmin), fmax, norm)
    return jnp.asarray(fb, dtype=default_float())


def mel_spectrogram(
    x,
    fs: float,
    nfft: int = 1024,
    hop: Optional[int] = None,
    n_mels: int = 80,
    window: WindowSpec = None,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = None,
    log: bool = False,
    eps: float = 1e-10,
) -> jax.Array:
    """(..., frames, n_mels) mel-scale power spectrogram.

    Power spectrogram -> (lp, n_mels) matmul; log=True applies
    ln(mel + eps).
    """
    fb = mel_filterbank(n_mels, nfft, fs, fmin, fmax, norm)
    p = spectrogram(x, nfft, hop, window, scale="power")  # (..., frames, lp)
    # HIGHEST keeps the filterbank contraction in full float32: at the
    # default precision a GPU runs it in TF32 (about 10 mantissa bits).
    m = jnp.matmul(p, fb.astype(p.dtype).T, precision=jax.lax.Precision.HIGHEST)
    return jnp.log(m + eps) if log else m


def stream_mel(
    chunks,
    fs: float,
    nfft: int = 1024,
    hop: Optional[int] = None,
    n_mels: int = 80,
    window: WindowSpec = None,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: Optional[str] = None,
    log: bool = False,
    eps: float = 1e-10,
):
    """Streaming mel front end: sample blocks in, (..., F_k, n_mels)
    mel (or log-mel) blocks out, one device program per block.

    The analysis mirror of models.stream_istft for hours-long audio: the
    (< nfft)-sample tail behind each block's last frame start is carried
    on the host (models._stft_impl._StreamingFramer), so the concatenation of
    the yielded blocks equals mel_spectrogram of the concatenated
    signal exactly.  Block lengths that are a multiple of hop keep one
    compiled program after the first chunk.
    """
    from godsp_tpu.models._stft_impl import _StreamingFramer

    hop_r = nfft // 2 if hop is None else hop
    if hop_r <= 0:
        raise ValueError("hop must be positive")
    framer = _StreamingFramer(nfft, hop_r)
    for block in chunks:
        seg = framer.push(block)
        if seg is not None:
            yield mel_spectrogram(
                seg, fs, nfft, hop_r, n_mels, window, fmin, fmax, norm,
                log=log, eps=eps,
            )


def mfcc(
    x,
    fs: float,
    n_mfcc: int = 13,
    nfft: int = 1024,
    hop: Optional[int] = None,
    n_mels: int = 80,
    window: WindowSpec = None,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> jax.Array:
    """(..., frames, n_mfcc) mel-frequency cepstral coefficients:
    DCT-II (ortho) of the log-mel spectrogram, first n_mfcc terms."""
    if n_mfcc > n_mels:
        raise ValueError("n_mfcc must be <= n_mels")
    logmel = mel_spectrogram(
        x, fs, nfft, hop, n_mels, window, fmin, fmax, norm="slaney", log=True
    )
    return dct(logmel, norm="ortho")[..., :n_mfcc]
