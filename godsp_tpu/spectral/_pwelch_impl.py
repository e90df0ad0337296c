"""Welch power spectral density (reference spectral/pwelch.go:28-145).

Semantics preserved exactly, including the reference's quirks:

  * defaults NFFT=256, window=Hann, Pad=NFFT, Noverlap=0, scaling ON
    (pwelch.go:85-95); `scale_off` is inverted so the zero value scales
    (pwelch.go:57-65);
  * input shorter than NFFT is zero-padded to NFFT (pwelch.go:97-99);
  * each segment is zero-padded to Pad FIRST and then windowed by a
    window of the segment's (post-pad) length (pwelch.go:108-109) — when
    Pad > NFFT the taper on the live samples is the head of the longer
    window, while the Sum(w^2) normalization still uses the NFFT-length
    window (pwelch.go:124-132); when Pad < NFFT the ZeroPadF is a no-op
    (dsputils.go:60-63), so the FFT runs at NFFT with the NFFT window and
    only the first pad/2+1 bins are kept;
  * one-sided spectrum of length pad/2+1 with interior bins doubled
    (pwelch.go:101, 113-121);
  * freqs[i] = i * Fs / pad (pwelch.go:138-142).

The per-segment loop becomes one batched windowed-FFT + mean over the
segment axis; the window table is hoisted out of the loop (bit-identical,
SURVEY.md appendix #10).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp

from godsp_tpu import window as win
from godsp_tpu._dtypes import as_real_array, default_float
from godsp_tpu.dsputils.utils import zero_pad
from godsp_tpu.fft.core import fft_real
from godsp_tpu.spectral._segment_impl import segment

__all__ = ["PwelchOptions", "pwelch", "pwelch_from_frames", "periodogram"]


WindowSpec = Union[str, Callable[[int], jax.Array], None]


@dataclass(frozen=True)
class PwelchOptions:
    """Options for pwelch; defaults and semantics of pwelch.go:28-65.

    nfft:     data points per block (0 -> 256).  Do not use for zero
              padding — use pad (the scaling would be wrong otherwise).
    window:   taper name or callable L -> array (None -> Hann).
    pad:      points each segment is padded to before the FFT (0 -> nfft).
    noverlap: overlapping points between blocks (default 0).
    scale_off: disable division by the sampling frequency.  Inverted flag
              kept for parity: the default (False) ENABLES scaling,
              giving density in Hz^-1 (MATLAB-compatible).
    """

    nfft: int = 0
    window: WindowSpec = None
    pad: int = 0
    noverlap: int = 0
    scale_off: bool = False

    def resolved(self) -> tuple[int, Callable[[int], jax.Array], int, int, bool]:
        nfft = self.nfft or 256
        wf = self.window if self.window is not None else win.hann
        if isinstance(wf, str):
            wf = win.WINDOWS[wf]
        pad = self.pad or nfft
        return nfft, wf, pad, self.noverlap, not self.scale_off


def pwelch(
    x,
    fs: float,
    options: Optional[PwelchOptions] = None,
) -> tuple[jax.Array, jax.Array]:
    """Estimate the PSD of x by Welch's method (pwelch.go:74-145).

    fs is the sampling frequency, used for the freqs grid and (unless
    scale_off) the density normalization.  Returns (Pxx, freqs), each of
    length pad/2 + 1.  Matplotlib/MATLAB-compatible by construction.
    """
    o = options or PwelchOptions()
    x = as_real_array(x)
    if x.shape[-1] == 0:  # pwelch.go:75-77
        f = default_float()
        return jnp.zeros(0, dtype=f), jnp.zeros(0, dtype=f)

    nfft, wf, pad, noverlap, enable_scaling = o.resolved()

    if x.shape[-1] < nfft:
        x = zero_pad(x, nfft)  # pwelch.go:97-99

    frames = segment(x, nfft, noverlap)  # (nsegs, nfft), pwelch.go:104
    return pwelch_from_frames(frames, fs, o)


@partial(jax.jit, static_argnames=("nfft", "fft_len", "lp"))
def _pwelch_core(frames, w_fft, w_norm, nfft: int, fft_len: int, lp: int):
    """Jitted windowed-periodogram average.

    frames: (..., nsegs, nfft) real; returns (..., lp) mean one-sided
    periodogram, pre-normalization by w_norm handled by caller.
    fft_len = max(pad, nfft): ZeroPadF is a no-op for pad < nfft.
    """
    padded = zero_pad(frames, fft_len)  # pwelch.go:108
    tapered = padded * w_fft  # pwelch.go:109 (post-pad-length window)
    spec = fft_real(tapered)[..., :lp]  # pwelch.go:111, one-sided
    p = spec.real * spec.real + spec.imag * spec.imag  # Re(conj(X)*X)
    p = p.mean(axis=-2)  # pwelch.go:113-121 (sum of d/nsegs)
    doubler = jnp.ones(lp, dtype=p.dtype).at[1 : lp - 1].set(2.0)
    return p * doubler / w_norm


def pwelch_from_frames(
    frames,
    fs: float,
    options: Optional[PwelchOptions] = None,
) -> tuple[jax.Array, jax.Array]:
    """Welch PSD from pre-framed segments of shape (..., nsegs, nfft).

    The building block the distributed/streaming drivers reduce over:
    mean-of-periodograms is associative, so per-shard partial means
    combine exactly (up to fp reordering) with a weighted psum
    (see godsp_tpu.parallel).
    """
    o = options or PwelchOptions()
    nfft, wf, pad, _, enable_scaling = o.resolved()
    frames = as_real_array(frames)
    if frames.shape[-1] != nfft:
        raise ValueError(f"frames must have trailing length nfft={nfft}")
    lp = pad // 2 + 1
    fft_len = max(pad, nfft)  # ZeroPadF no-op for pad < nfft

    fdt = frames.dtype
    w_fft = win.window_table(wf, fft_len).astype(fdt)
    w_nfft = win.window_table(wf, nfft).astype(fdt)
    w_norm = jnp.sum(w_nfft * w_nfft)  # pwelch.go:124-128
    if enable_scaling:
        w_norm = w_norm * jnp.asarray(fs, dtype=fdt)  # pwelch.go:130-132

    pxx = _pwelch_core(frames, w_fft, w_norm, nfft, fft_len, lp)
    freqs = jnp.arange(lp, dtype=fdt) * (fs / pad)  # pwelch.go:138-142
    return pxx, freqs


def periodogram(
    x,
    fs: float,
    window: WindowSpec = "rectangular",
    pad: int = 0,
    scale_off: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Single-segment one-sided PSD: Pwelch with nfft = len(x).

    Default window is rectangular (the classical periodogram;
    scipy.signal.periodogram-compatible with detrend off).  Returns
    (Pxx, freqs) of length (pad or len(x))//2 + 1.
    """
    x = as_real_array(x)
    n = int(x.shape[-1])
    if n == 0:
        f = default_float()
        return jnp.zeros(0, dtype=f), jnp.zeros(0, dtype=f)
    o = PwelchOptions(nfft=n, window=window, pad=pad, noverlap=0,
                      scale_off=scale_off)
    return pwelch(x, fs, o)
