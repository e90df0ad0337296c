"""Cross-spectral density and magnitude-squared coherence (Welch).

Extends the reference's auto-spectral Pwelch (spectral/pwelch.go) to
pairs of signals — the other half of standard spectral analysis:

  csd(x, y)       one-sided Pxy = mean_segments conj(X_s) * Y_s, with
                  the same framing/window/normalization conventions as
                  pwelch (scipy.signal.csd-compatible with detrend off);
  coherence(x, y) Cxy = |Pxy|^2 / (Pxx * Pyy).

Per-segment spectra are batched framing + FFT; averaging and
normalization are tiny XLA ops.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from godsp_tpu import window as win
from godsp_tpu._dtypes import as_real_array, default_float
from godsp_tpu.dsputils.utils import zero_pad
from godsp_tpu.fft.core import fft_real
from godsp_tpu.spectral._pwelch_impl import PwelchOptions
from godsp_tpu.spectral._segment_impl import segment

__all__ = ["csd", "coherence"]


def csd(
    x,
    y,
    fs: float,
    options: Optional[PwelchOptions] = None,
) -> tuple[jax.Array, jax.Array]:
    """One-sided cross power spectral density of x and y.

    Same conventions as spectral.pwelch (defaults NFFT=256, Hann,
    Pad=NFFT, Noverlap=0, density scaling unless scale_off); returns
    (Pxy, freqs) with Pxy complex of length pad//2 + 1.
    csd(x, x) equals pwelch(x) exactly.
    """
    o = options or PwelchOptions()
    x = as_real_array(x)
    y = as_real_array(y)
    if x.shape != y.shape:
        raise ValueError("x and y must have identical shapes")
    if x.shape[-1] == 0:
        f = default_float()
        z = jnp.zeros(0, dtype=f)
        return z.astype(jnp.complex64), z

    nfft, wf, pad, noverlap, enable_scaling = o.resolved()
    stride = nfft - noverlap
    if stride <= 0:
        raise ValueError("noverlap must be < nfft")
    if x.shape[-1] < nfft:
        x = zero_pad(x, nfft)  # pwelch.go:97-99
        y = zero_pad(y, nfft)

    # Windowing convention: pwelch zero-pads each segment to pad FIRST
    # and then applies a pad-length taper (pwelch.go:108-109), so the
    # live nfft samples see the HEAD of the pad-length window.  Applying
    # the pad-length table to nfft-zero-extended frames reproduces that
    # exactly, so spectra are built from frames directly here rather
    # than through models.stft (which tapers at nfft before padding).
    fdt = x.dtype
    lp = pad // 2 + 1
    # ZeroPadF(seg, pad) is a no-op when pad < nfft (dsputils.go:60-63):
    # the FFT then runs at nfft and only the first lp bins are kept —
    # same semantics as spectral.pwelch.
    fft_len = max(pad, nfft)
    w_pad = win.window_table(wf, fft_len).astype(fdt)
    w_nfft = win.window_table(wf, nfft).astype(fdt)
    w_norm = jnp.sum(w_nfft * w_nfft)
    if enable_scaling:
        w_norm = w_norm * jnp.asarray(fs, dtype=fdt)

    doubler = jnp.ones(lp, dtype=fdt).at[1 : lp - 1].set(2.0)

    def spectra(sig):
        frames = segment(sig, nfft, noverlap)
        padded = zero_pad(frames, fft_len) * w_pad
        return fft_real(padded)[..., :lp]

    X = spectra(x)
    Y = spectra(y)
    pxy = jnp.mean(jnp.conj(X) * Y, axis=-2)
    pxy = pxy * doubler / w_norm
    freqs = jnp.arange(lp, dtype=fdt) * (fs / pad)
    return pxy, freqs


def coherence(
    x,
    y,
    fs: float,
    options: Optional[PwelchOptions] = None,
) -> tuple[jax.Array, jax.Array]:
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy) in [0, 1].

    Requires overlap/averaging over multiple segments to be meaningful
    (with one segment Cxy is identically 1).
    """
    from godsp_tpu.spectral._pwelch_impl import pwelch

    pxy, freqs = csd(x, y, fs, options)
    pxx, _ = pwelch(x, fs, options)
    pyy, _ = pwelch(y, fs, options)
    denom = pxx * pyy
    cxy = (pxy.real**2 + pxy.imag**2) / jnp.maximum(
        denom, jnp.finfo(denom.dtype).tiny
    )
    return cxy, freqs
