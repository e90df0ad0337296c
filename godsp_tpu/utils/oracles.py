"""Float64 numpy reference oracles, independent of the device code.

Each oracle recomputes a framework result with plain numpy in float64
from the reference's semantics, so a device result can be scored
against it (dsputils.snr_db).  They are host-only and make no JAX call.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["csd_np", "pwelch_np", "tone_signal", "tone_snr_db"]


def _segment_spectra(x64, nfft, noverlap, wname, pad, block_segs):
    """Yield (spectra block, segment count): one-sided FFTs of the
    windowed, pad-extended segments of the trailing axis, block_segs
    segments at a time, so a long signal never materializes all its
    frames at once."""
    from godsp_tpu import window as win

    x64 = np.asarray(x64, dtype=np.float64)
    fft_len = max(pad, nfft)
    stride = nfft - noverlap
    nsegs = (x64.shape[-1] - nfft) // stride + 1
    w = win.window_table_np(wname, fft_len)
    for s0 in range(0, nsegs, block_segs):
        s1 = min(s0 + block_segs, nsegs)
        idx = np.arange(s0, s1)[:, None] * stride + np.arange(nfft)[None, :]
        frames = x64[..., idx]
        if fft_len > nfft:
            frames = np.concatenate(
                [frames, np.zeros(frames.shape[:-1] + (fft_len - nfft,))], axis=-1
            )
        yield np.fft.rfft(frames * w, axis=-1)[..., : pad // 2 + 1], nsegs


def _normalize(acc, nsegs, fs, nfft, wname):
    """One-sided interior doubling and the sum(w_nfft^2) * fs density
    scale of pwelch.go:113-136."""
    from godsp_tpu import window as win

    lp = acc.shape[-1]
    acc[..., 1 : lp - 1] *= 2.0
    wn = win.window_table_np(wname, nfft)
    return acc / nsegs / (float(np.sum(wn * wn)) * fs)


def pwelch_np(
    x64: np.ndarray,
    fs: float,
    nfft: int,
    noverlap: int,
    wname="hann",
    pad: Optional[int] = None,
    block_segs: int = 1 << 14,
) -> np.ndarray:
    """Reference-semantics Pwelch in float64 numpy (pwelch.go:74-145).

    Integer-overlap segmentation of the trailing axis, each segment
    zero-padded to pad and windowed at the pad length, one-sided with
    interior-bin doubling, normalized by sum(w_nfft^2) * fs.  Leading
    axes batch; segments are accumulated block_segs at a time.
    """
    pad = nfft if pad is None else pad
    acc = 0.0
    for X, nsegs in _segment_spectra(x64, nfft, noverlap, wname, pad, block_segs):
        acc = acc + (X.real**2 + X.imag**2).sum(axis=-2)
    return _normalize(acc, nsegs, fs, nfft, wname)


def csd_np(
    x64: np.ndarray,
    y64: np.ndarray,
    fs: float,
    nfft: int,
    noverlap: int,
    wname="hann",
    pad: Optional[int] = None,
    block_segs: int = 1 << 14,
) -> np.ndarray:
    """Cross spectral density mean(conj(X) * Y) with pwelch_np's
    framing, window and scaling (spectral.csd semantics); csd_np(x, x)
    equals pwelch_np(x)."""
    pad = nfft if pad is None else pad
    acc = 0.0
    for (X, nsegs), (Y, _) in zip(
        _segment_spectra(x64, nfft, noverlap, wname, pad, block_segs),
        _segment_spectra(y64, nfft, noverlap, wname, pad, block_segs),
    ):
        acc = acc + (np.conj(X) * Y).sum(axis=-2)
    return _normalize(acc, nsegs, fs, nfft, wname)


def tone_signal(n: int, tones: Sequence[tuple[int, float, float]]) -> np.ndarray:
    """complex128 sum of integer-bin tones a * exp(2 pi i (f k / n + ph)).

    Its DFT is exactly n * a * exp(2 pi i ph) at bin f and 0 elsewhere;
    the phase is reduced with (f * k) mod n in integers, so the signal
    is exact to float64 rounding at any n.
    """
    k = np.arange(n, dtype=np.int64)
    z = np.zeros(n, np.complex128)
    for f, a, ph in tones:
        z += a * np.exp(2j * np.pi * (((f * k) % n) / n + ph))
    return z


def tone_snr_db(X: np.ndarray, tones: Sequence[tuple[int, float, float]]) -> float:
    """SNR in dB of a spectrum X of tone_signal(len(X), tones) against
    the closed form, without building the closed-form spectrum.

    The error energy is the residual energy off the tone bins plus the
    error at each tone bin: the tone bins are zeroed FIRST and the rest
    summed, since subtracting two ~n^2-sized energies would bottom out
    at the cancellation floor whatever the transform's accuracy.
    """
    X = np.asarray(X, dtype=np.complex128)
    n = X.shape[-1]
    resid = X.copy()
    sig = err = 0.0
    for f, a, ph in tones:
        want = n * a * np.exp(2j * np.pi * ph)
        sig += abs(want) ** 2
        err += abs(X[f] - want) ** 2
        resid[f] = 0.0
    err += float(np.sum(resid.real**2 + resid.imag**2))
    return float(10.0 * np.log10(sig / max(err, 1e-300)))
