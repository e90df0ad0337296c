"""scipy-compatible Welch estimator (the modern-API twin of pwelch).

`pwelch` preserves the reference's exact semantics and quirks
(pwelch.go:28-145, symmetric tapers, no detrend, pad-then-window); this
module provides the scipy.signal.welch surface users coming from scipy
expect — PERIODIC windows, per-segment detrending, density/spectrum
scaling, mean/median averaging, two-sided complex support — on the same
batched device machinery (one framed windowed-FFT program, jit-fused).
Returns (freqs, Pxx) in scipy's order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import as_complex_array, default_float, put
from godsp_tpu.fft.core import fft, fft_real
from godsp_tpu.spectral._segment_impl import segment

__all__ = ["lombscargle", "spectrogram_scipy", "welch", "welch_coherence", "welch_csd"]


def _periodic_table_np(window, nperseg: int) -> np.ndarray:
    """Resolve a scipy-style window spec to a float64 PERIODIC table
    (scipy's get_window(..., fftbins=True)): any catalogue name or
    (name, *params) tuple via window.extended.get_window, or an
    explicit length-nperseg array (used as given)."""
    if isinstance(window, (str, bytes)) or isinstance(window, tuple) or (
        isinstance(window, (int, float)) and not isinstance(window, bool)
    ):
        from godsp_tpu.window.extended import get_window

        spec = tuple(window) if isinstance(window, tuple) else window
        return get_window(spec, nperseg, fftbins=True)
    if isinstance(window, list) and window and isinstance(window[0], str):
        from godsp_tpu.window.extended import get_window

        return get_window(tuple(window), nperseg, fftbins=True)
    w = np.asarray(window, np.float64)
    if w.ndim != 1 or w.shape[0] != nperseg:
        raise ValueError(f"window array must have length nperseg={nperseg}")
    return w


def _detrend_segments(frames: jax.Array, detrend) -> jax.Array:
    if detrend is False or detrend is None:
        return frames
    if callable(detrend):
        return detrend(frames)
    from godsp_tpu.dsputils.utils import detrend as _dt

    if detrend in ("constant", "c"):
        return _dt(frames, type="constant")
    if detrend in ("linear", "l"):
        return _dt(frames, type="linear")
    raise ValueError("detrend must be 'constant', 'linear', False, or callable")


def _median_bias(n: int) -> float:
    """Bias of the median of n periodogram estimates relative to the
    mean (scipy.signal._spectral_py._median_bias)."""
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


@partial(
    jax.jit,
    static_argnames=("nfft", "onesided", "detrend_kind", "average", "nsegs"),
)
def _welch_core(frames, w, scale, nfft: int, onesided: bool,
                detrend_kind, average: str, nsegs: int):
    frames = _detrend_segments(frames, detrend_kind)
    nperseg = frames.shape[-1]
    tapered = frames * w
    if nfft > nperseg:
        padw = [(0, 0)] * (tapered.ndim - 1) + [(0, nfft - nperseg)]
        tapered = jnp.pad(tapered, padw)
    if onesided:
        lp = nfft // 2 + 1
        spec = fft_real(tapered)[..., :lp]
        p = spec.real * spec.real + spec.imag * spec.imag
        doubler = jnp.ones(lp, dtype=p.dtype).at[1 : lp - 1 + (nfft % 2)].set(2.0)
        p = p * doubler
    else:
        spec = fft(as_complex_array(tapered))
        p = spec.real * spec.real + spec.imag * spec.imag
    p = p * scale
    if average == "median":
        p = jnp.median(p, axis=-2) / _median_bias(nsegs)
    else:
        p = p.mean(axis=-2)
    return p


@partial(
    jax.jit,
    static_argnames=("nfft", "onesided", "detrend_kind", "average", "nsegs"),
)
def _csd_core(fx, fy, w, scale, nfft: int, onesided: bool,
              detrend_kind, average: str, nsegs: int):
    def spec_of(frames):
        frames = _detrend_segments(frames, detrend_kind)
        nperseg = frames.shape[-1]
        tapered = frames * w
        if nfft > nperseg:
            padw = [(0, 0)] * (tapered.ndim - 1) + [(0, nfft - nperseg)]
            tapered = jnp.pad(tapered, padw)
        if onesided:
            return fft_real(tapered)[..., : nfft // 2 + 1]
        return fft(as_complex_array(tapered))

    sx = spec_of(fx)
    sy = spec_of(fy)
    p = jnp.conj(sx) * sy
    if onesided:
        lp = nfft // 2 + 1
        doubler = jnp.ones(lp, dtype=p.real.dtype)
        doubler = doubler.at[1 : lp - 1 + (nfft % 2)].set(2.0)
        p = p * doubler
    p = p * scale
    if average == "median":
        bias = _median_bias(nsegs)
        p = jax.lax.complex(
            jnp.median(p.real, axis=-2) / bias, jnp.median(p.imag, axis=-2) / bias
        )
    else:
        p = p.mean(axis=-2)
    return p


def welch_csd(
    x,
    y,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    return_onesided: bool = True,
    scaling: str = "density",
    axis: int = -1,
    average: str = "mean",
):
    """Cross power spectral density with scipy.signal.csd semantics:
    returns (freqs, Pxy) with Pxy complex (conj(X) * Y averaged over
    segments).  The scipy-convention twin of the reference-parity
    spectral.csd (symmetric tapers, no detrend); welch_csd(x, x).real
    == welch(x)."""
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    if average not in ("mean", "median"):
        raise ValueError("average must be 'mean' or 'median'")
    x = put(x)
    y = put(y)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(default_float())
    if not jnp.issubdtype(y.dtype, jnp.inexact):
        y = y.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    y = jnp.moveaxis(y, axis, -1)
    if x.shape != y.shape:
        raise ValueError("x and y must have identical shapes")
    n = x.shape[-1]
    if n == 0:
        f = default_float()
        zf = jnp.zeros(0, dtype=f)
        return zf, jnp.zeros(x.shape[:-1] + (0,), dtype=jnp.complex64)
    if nperseg is None:
        nperseg = 256
    nperseg = int(min(nperseg, n))
    if noverlap is None:
        noverlap = nperseg // 2
    noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")

    is_complex = jnp.issubdtype(x.dtype, jnp.complexfloating) or jnp.issubdtype(
        y.dtype, jnp.complexfloating
    )
    onesided = return_onesided and not is_complex

    wt = _periodic_table_np(window, nperseg)
    fdt = x.real.dtype
    w = jnp.asarray(wt, fdt)
    if scaling == "density":
        scale = 1.0 / (float(fs) * float(np.sum(wt * wt)))
    else:
        scale = 1.0 / float(np.sum(wt)) ** 2
    scale = jnp.asarray(scale, fdt)

    def frames_of(v):
        if jnp.issubdtype(v.dtype, jnp.complexfloating):
            return jax.lax.complex(
                segment(v.real, nperseg, noverlap),
                segment(v.imag, nperseg, noverlap),
            )
        return segment(v, nperseg, noverlap)

    fx, fy = frames_of(x), frames_of(y)
    nsegs = fx.shape[-2]
    dk = detrend if (callable(detrend) or detrend is False or detrend is None) \
        else str(detrend)
    pxy = _csd_core(fx, fy, w, scale, nfft, onesided, dk, average, nsegs)
    if onesided:
        freqs = jnp.arange(nfft // 2 + 1, dtype=fdt) * (float(fs) / nfft)
    else:
        from godsp_tpu.fft.helpers import fftfreq

        freqs = fftfreq(nfft, 1.0 / float(fs)).astype(fdt)
    return freqs, jnp.moveaxis(pxy, -1, axis) if pxy.ndim > 1 else pxy


def welch_coherence(
    x,
    y,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    axis: int = -1,
):
    """Magnitude-squared coherence Cxy = |Pxy|^2 / (Pxx Pyy) with
    scipy.signal.coherence semantics (the scipy-convention twin of the
    reference-parity spectral.coherence)."""
    kw = dict(fs=fs, window=window, nperseg=nperseg, noverlap=noverlap,
              nfft=nfft, detrend=detrend, axis=axis)
    freqs, pxx = welch(x, **kw)
    _, pyy = welch(y, **kw)
    _, pxy = welch_csd(x, y, **kw)
    return freqs, (pxy.real**2 + pxy.imag**2) / (pxx * pyy)


def welch(
    x,
    fs: float = 1.0,
    window="hann",
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    return_onesided: bool = True,
    scaling: str = "density",
    axis: int = -1,
    average: str = "mean",
):
    """Welch PSD with scipy.signal.welch semantics: returns (freqs, Pxx)
    along `axis` (other axes batch).  Real input -> one-sided spectrum
    (unless return_onesided=False); complex input -> two-sided.
    scaling='density' (V**2/Hz, 1/(fs*sum(w^2))) or 'spectrum' (V**2,
    1/sum(w)^2); average='mean' or 'median' (bias-corrected)."""
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    if average not in ("mean", "median"):
        raise ValueError("average must be 'mean' or 'median'")
    x = put(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n == 0:
        f = default_float()
        return jnp.zeros(0, dtype=f), jnp.zeros(x.shape[:-1] + (0,), dtype=f)
    if nperseg is None:
        nperseg = 256
    nperseg = int(min(nperseg, n))
    if noverlap is None:
        noverlap = nperseg // 2
    noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")

    is_complex = jnp.issubdtype(x.dtype, jnp.complexfloating)
    onesided = return_onesided and not is_complex

    wt = _periodic_table_np(window, nperseg)
    fdt = x.real.dtype
    w = jnp.asarray(wt, fdt)
    if scaling == "density":
        scale = 1.0 / (float(fs) * float(np.sum(wt * wt)))
    else:
        scale = 1.0 / float(np.sum(wt)) ** 2
    scale = jnp.asarray(scale, fdt)

    if is_complex:
        fr = segment(x.real, nperseg, noverlap)
        fi = segment(x.imag, nperseg, noverlap)
        frames = jax.lax.complex(fr, fi)
    else:
        frames = segment(x, nperseg, noverlap)  # (..., nsegs, nperseg)
    nsegs = frames.shape[-2]
    dk = detrend if (callable(detrend) or detrend is False or detrend is None) \
        else str(detrend)
    pxx = _welch_core(frames, w, scale, nfft, onesided, dk, average, nsegs)
    if onesided:
        freqs = jnp.arange(nfft // 2 + 1, dtype=fdt) * (float(fs) / nfft)
    else:
        from godsp_tpu.fft.helpers import fftfreq

        freqs = fftfreq(nfft, 1.0 / float(fs)).astype(fdt)
    return freqs, jnp.moveaxis(pxx, -1, axis) if pxx.ndim > 1 else pxx


@partial(
    jax.jit,
    static_argnames=("nfft", "onesided", "detrend_kind", "mode"),
)
def _spectrogram_core(frames, w, scale, nfft: int, onesided: bool,
                      detrend_kind, mode: str):
    frames = _detrend_segments(frames, detrend_kind)
    nperseg = frames.shape[-1]
    tapered = frames * w
    if nfft > nperseg:
        padw = [(0, 0)] * (tapered.ndim - 1) + [(0, nfft - nperseg)]
        tapered = jnp.pad(tapered, padw)
    if onesided:
        spec = fft_real(tapered)[..., : nfft // 2 + 1]
    else:
        spec = fft(as_complex_array(tapered))
    if mode == "complex":
        return spec * jnp.sqrt(scale)
    if mode == "magnitude":  # |X| * sqrt(scale), no one-sided doubling
        return jnp.abs(spec) * jnp.sqrt(scale)
    p = spec.real * spec.real + spec.imag * spec.imag
    if onesided:
        lp = nfft // 2 + 1
        doubler = jnp.ones(lp, dtype=p.dtype).at[1 : lp - 1 + (nfft % 2)].set(2.0)
        p = p * doubler
    return p * scale  # psd


def spectrogram_scipy(
    x,
    fs: float = 1.0,
    window=("tukey", 0.25),
    nperseg: int | None = None,
    noverlap: int | None = None,
    nfft: int | None = None,
    detrend="constant",
    return_onesided: bool = True,
    scaling: str = "density",
    axis: int = -1,
    mode: str = "psd",
):
    """Per-segment spectrogram with scipy.signal.spectrogram semantics:
    returns (freqs, times, Sxx) with the segment axis LAST (scipy's
    layout; the framework's models.spectrogram keeps frames on -2).
    mode: 'psd' (scaled power), 'magnitude' (sqrt of the scaled power
    without one-sided doubling... matching scipy: magnitude applies
    sqrt(scale) to |X|), or 'complex' (scaled spectrum).  Default
    noverlap is nperseg//8 (scipy's spectrogram default)."""
    if mode not in ("psd", "magnitude", "complex"):
        raise ValueError("mode must be 'psd', 'magnitude', or 'complex'")
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    x = put(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if nperseg is None:
        nperseg = 256
    nperseg = int(min(nperseg, n))
    if noverlap is None:
        noverlap = nperseg // 8
    noverlap = int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    wt = _periodic_table_np(window, nperseg)
    is_complex = jnp.issubdtype(x.dtype, jnp.complexfloating)
    onesided = return_onesided and not is_complex
    fdt = x.real.dtype
    w = jnp.asarray(wt, fdt)
    if scaling == "density":
        scale = 1.0 / (float(fs) * float(np.sum(wt * wt)))
    else:
        scale = 1.0 / float(np.sum(wt)) ** 2
    scale = jnp.asarray(scale, fdt)
    if is_complex:
        frames = jax.lax.complex(
            segment(x.real, nperseg, noverlap), segment(x.imag, nperseg, noverlap)
        )
    else:
        frames = segment(x, nperseg, noverlap)
    nsegs = frames.shape[-2]
    dk = detrend if (callable(detrend) or detrend is False or detrend is None) \
        else str(detrend)
    sxx = _spectrogram_core(frames, w, scale, nfft, onesided, dk, mode)
    sxx = jnp.swapaxes(sxx, -1, -2)  # scipy: freq axis then time axis last
    if onesided:
        freqs = jnp.arange(nfft // 2 + 1, dtype=fdt) * (float(fs) / nfft)
    else:
        from godsp_tpu.fft.helpers import fftfreq

        freqs = fftfreq(nfft, 1.0 / float(fs)).astype(fdt)
    step = nperseg - noverlap
    times = (jnp.arange(nsegs, dtype=fdt) * step + nperseg / 2.0) / float(fs)
    return freqs, times, sxx



@partial(jax.jit, static_argnames=("precenter", "normalize"))
def _lombscargle_jit(x, y, freqs, precenter: bool, normalize: bool):
    if precenter:
        y = y - jnp.mean(y)
    # classical Lomb-Scargle with per-frequency time offset tau
    wt = freqs[:, None] * x[None, :]  # (nf, n)
    s2 = jnp.sum(jnp.sin(2 * wt), axis=-1)
    c2 = jnp.sum(jnp.cos(2 * wt), axis=-1)
    tau = 0.5 * jnp.arctan2(s2, c2)
    arg = wt - tau[:, None]
    cw = jnp.cos(arg)
    sw = jnp.sin(arg)
    yc = jnp.sum(y[None, :] * cw, axis=-1)
    ys = jnp.sum(y[None, :] * sw, axis=-1)
    cc = jnp.sum(cw * cw, axis=-1)
    ss_ = jnp.sum(sw * sw, axis=-1)
    p = 0.5 * (yc * yc / cc + ys * ys / ss_)
    if normalize:
        p = p * 2.0 / jnp.sum(y * y)
    return p


def lombscargle(x, y, freqs, precenter: bool = False, normalize: bool = False):
    """Lomb-Scargle periodogram of unevenly sampled data
    (scipy.signal.lombscargle's classical form): the per-frequency
    phase-shifted least-squares sinusoid fit power.  One batched outer
    trig product — (n_freqs, n_samples) elementwise work that XLA tiles
    across lanes, vs scipy's per-frequency C loop."""
    x = put(x)
    y = put(y)
    freqs = put(freqs)
    fdt = default_float()
    x = x.astype(fdt)
    y = y.astype(fdt)
    freqs = jnp.asarray(freqs, fdt)
    if x.ndim != 1 or y.ndim != 1 or freqs.ndim != 1:
        raise ValueError("x, y, freqs must be 1-D")
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y must have the same length")
    return _lombscargle_jit(x, y, freqs, bool(precenter), bool(normalize))
