"""Resampling: Fourier method and polyphase (scipy.signal semantics).

`resample` transforms, truncates/zero-pads the spectrum (Nyquist bin
split handled exactly as scipy does), and inverse transforms — all
through the framework's FFT dispatch (four-step for power-of-2 lengths).

`resample_poly`/`upfirdn` do rational-rate polyphase resampling: the
anti-alias FIR is designed host-side in float64 at trace time
(`firwin`, window method), and the filtering itself runs as ONE batched
kernel-chain convolution (models.filter.fftconvolve) over the
zero-stuffed signal — no per-phase loops on device.
"""

from __future__ import annotations

from functools import partial
from math import gcd

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import as_complex_array, put
from godsp_tpu.fft.core import _fft_jit, _ifft_jit

__all__ = [
    "decimate",
    "firwin",
    "firwin2",
    "kaiser_atten",
    "kaiser_beta",
    "kaiserord",
    "resample",
    "resample_poly",
    "upfirdn",
]


@partial(jax.jit, static_argnames=("num", "real_out", "domain"))
def _resample_jit(x, num: int, real_out: bool, W=None, domain: str = "time"):
    n = x.shape[-1]
    X = as_complex_array(x) if domain == "freq" else _fft_jit(as_complex_array(x))
    if W is not None:
        X = X * W.astype(X.dtype)
    m = min(n, num)
    half = m // 2
    lead = X.shape[:-1]
    Y = jnp.zeros(lead + (num,), dtype=X.dtype)
    Y = Y.at[..., : half + 1].set(X[..., : half + 1])
    if half > 0:
        Y = Y.at[..., num - (m - 1 - half) :].set(X[..., n - (m - 1 - half) :])
    if m % 2 == 0:  # split/merge the Nyquist bin exactly as scipy does
        if num < n:  # downsampling: fold the mirrored bin in
            Y = Y.at[..., half].add(X[..., n - half])
        elif num > n:  # upsampling: split it between +/- Nyquist
            Y = Y.at[..., half].mul(0.5)
            Y = Y.at[..., num - half].set(Y[..., half])
    y = _ifft_jit(Y) * (num / n)
    return jnp.real(y) if real_out else y


def resample(x, num: int, t=None, axis: int = -1, window=None,
             domain: str = "time"):
    """Resample along `axis` to `num` points (Fourier method, full
    scipy.signal.resample surface; assumes the signal is periodic).

    window: optional spectral taper — a get_window spec (applied
    fftshifted, scipy convention), a callable of fftfreq(n), or an
    explicit length-n array in FFT bin order.  domain='freq' treats x
    as an already-computed spectrum.  With `t` given, returns
    (resampled, new_t).  Real input returns real output."""
    if num < 1:
        raise ValueError("num must be >= 1")
    if domain not in ("time", "freq"):
        raise ValueError("domain must be 'time' or 'freq'")
    x = put(x)
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    W = None
    if window is not None:
        if callable(window):
            Wnp = np.asarray(window(np.fft.fftfreq(n)), np.float64)
        elif isinstance(window, np.ndarray) or (
            hasattr(window, "ndim") and not isinstance(window, (str, bytes))
        ):
            Wnp = np.asarray(window, np.float64)
            if Wnp.shape != (n,):
                raise ValueError("window array must have the axis length")
        else:
            from godsp_tpu.window.extended import get_window

            Wnp = np.fft.fftshift(get_window(window, n, fftbins=True))
        W = jnp.asarray(Wnp)
    real_out = x.dtype.kind != "c"
    y = _resample_jit(x, int(num), real_out, W, domain)
    y = jnp.moveaxis(y, -1, axis) if y.ndim > 1 else y
    if t is None:
        return y
    t = np.asarray(t)
    new_t = np.arange(0, num) * (t[1] - t[0]) * n / float(num) + t[0]
    return y, new_t


def _window_vector_np(window, numtaps: int) -> np.ndarray:
    """Resolve a firwin window spec to a float64 length-numtaps table:
    a name from godsp_tpu.window, ("kaiser", beta), a callable, or an
    explicit array."""
    from godsp_tpu import window as win

    if (
        isinstance(window, tuple)
        and len(window) == 2
        and str(window[0]).lower() == "kaiser"
    ):
        return win._kaiser_table(float(window[1]), numtaps)
    if isinstance(window, (str, bytes)) or callable(window):
        return win.window_table_np(window, numtaps)
    w = np.asarray(window, np.float64)
    if w.shape != (numtaps,):
        raise ValueError(f"window must have {numtaps} taps, got {w.shape}")
    return w


def firwin(
    numtaps: int,
    cutoff,
    window=("kaiser", 5.0),
    pass_zero: bool = True,
    scale: bool = True,
) -> np.ndarray:
    """Window-method FIR design (scipy.signal.firwin; cutoff normalized
    to Nyquist == 1).  Scalar cutoff: lowpass (pass_zero=True) or
    highpass; two cutoffs: bandstop (pass_zero=True) or bandpass.
    Returns float64 numpy taps — a trace-time constant for the device
    filtering paths (upfirdn, fir_filter, overlap_save)."""
    numtaps = int(numtaps)
    if numtaps < 1:
        raise ValueError("numtaps must be >= 1")
    cut = np.atleast_1d(np.asarray(cutoff, np.float64))
    if cut.ndim != 1 or cut.size == 0:
        raise ValueError("cutoff must be a scalar or 1-D sequence")
    if np.any(cut <= 0) or np.any(cut >= 1):
        raise ValueError("cutoff must lie strictly inside (0, 1)")
    if np.any(np.diff(cut) <= 0):
        raise ValueError("cutoff frequencies must be strictly increasing")
    pass_nyquist = bool(cut.size & 1) ^ bool(pass_zero)
    if pass_nyquist and numtaps % 2 == 0:
        raise ValueError(
            "an even numtaps cannot pass the Nyquist frequency"
        )
    edges = np.hstack(
        ([0.0] if pass_zero else []) + [cut] + ([1.0] if pass_nyquist else [])
    ).reshape(-1, 2)
    m = np.arange(numtaps, dtype=np.float64) - (numtaps - 1) / 2.0
    h = np.zeros(numtaps, np.float64)
    for left, right in edges:
        h += right * np.sinc(right * m) - left * np.sinc(left * m)
    h *= _window_vector_np(window, numtaps)
    if scale:
        left, right = edges[0]
        f = 0.0 if left == 0 else (1.0 if right == 1 else (left + right) / 2)
        h /= np.sum(h * np.cos(np.pi * m * f))
    return h


def firwin2(
    numtaps: int,
    freq,
    gain,
    nfreqs: int | None = None,
    window="hamming",
    antisymmetric: bool = False,
) -> np.ndarray:
    """Frequency-sampling FIR design (scipy.signal.firwin2): taps whose
    response interpolates the piecewise-linear (freq, gain) pairs (freq
    normalized to Nyquist == 1).  Linear-phase type I-IV chosen by
    numtaps parity and `antisymmetric`, with the usual endpoint-gain
    constraints.  Returns float64 numpy taps (trace-time constant)."""
    numtaps = int(numtaps)
    if numtaps < 3:
        raise ValueError("numtaps must be >= 3")
    freq = np.asarray(freq, np.float64).copy()
    gain = np.asarray(gain, np.float64)
    if freq.ndim != 1 or freq.shape != gain.shape:
        raise ValueError("freq and gain must be 1-D with equal length")
    if freq[0] != 0.0 or freq[-1] != 1.0:
        raise ValueError("freq must start with 0 and end with 1 (Nyquist)")
    if np.any(np.diff(freq) < 0):
        raise ValueError("freq must be nondecreasing")
    if antisymmetric:
        ftype = 3 if numtaps % 2 else 4
    else:
        ftype = 1 if numtaps % 2 else 2
    if ftype == 2 and gain[-1] != 0.0:
        raise ValueError("type II filter (even numtaps, symmetric) needs "
                         "zero gain at the Nyquist frequency")
    if ftype == 3 and (gain[0] != 0.0 or gain[-1] != 0.0):
        raise ValueError("type III filter (odd numtaps, antisymmetric) "
                         "needs zero gain at zero and Nyquist")
    if ftype == 4 and gain[0] != 0.0:
        raise ValueError("type IV filter (even numtaps, antisymmetric) "
                         "needs zero gain at the zero frequency")
    if nfreqs is None:
        nfreqs = 1 + 2 ** int(np.ceil(np.log2(numtaps)))
    nfreqs = int(nfreqs)
    if numtaps >= nfreqs:
        raise ValueError("nfreqs must be greater than numtaps")
    # nudge duplicated interior breakpoints apart so np.interp keeps both
    eps = np.finfo(np.float64).eps
    for k in range(freq.size - 1):
        if freq[k] == freq[k + 1]:
            freq[k] -= eps
            freq[k + 1] += eps
    if np.any(np.diff(freq) <= 0):
        raise ValueError("freq cannot contain more than two duplicate values")
    x = np.linspace(0.0, 1.0, nfreqs)
    fx = np.interp(x, freq, gain)
    shift = np.exp(-(numtaps - 1) / 2.0 * 1j * np.pi * x)
    if ftype > 2:
        shift *= 1j
    out_full = np.fft.irfft(fx * shift)
    wind = _window_vector_np(window, numtaps) if window is not None else 1.0
    out = out_full[:numtaps] * wind
    if ftype == 3:
        out[out.size // 2] = 0.0
    return out


def kaiser_beta(a: float) -> float:
    """Kaiser-window beta for `a` dB of stopband attenuation (the
    standard empirical fit; scipy.signal.kaiser_beta)."""
    a = float(a)
    if a > 50:
        return 0.1102 * (a - 8.7)
    if a > 21:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    return 0.0


def kaiser_atten(numtaps: int, width: float) -> float:
    """Attenuation (dB) of a numtaps-Kaiser filter with transition
    `width` (normalized to Nyquist == 1); scipy.signal.kaiser_atten."""
    return 2.285 * (int(numtaps) - 1) * np.pi * float(width) + 7.95


def kaiserord(ripple: float, width: float) -> tuple[int, float]:
    """(numtaps, beta) meeting `ripple` dB and transition `width`
    (scipy.signal.kaiserord)."""
    A = abs(float(ripple))
    if A < 8:
        raise ValueError("ripple attenuation too small for the Kaiser formula "
                         "(need at least 8 dB)")
    beta = kaiser_beta(A)
    numtaps = (A - 7.95) / 2.285 / (np.pi * float(width)) + 1
    return int(np.ceil(numtaps)), beta


def _upfirdn_len(len_h: int, n_in: int, up: int, down: int) -> int:
    return ((n_in - 1) * up + len_h - 1) // down + 1


def upfirdn(h, x, up: int = 1, down: int = 1, axis: int = -1) -> jax.Array:
    """Upsample by `up` (zero stuffing), FIR filter with h, downsample
    by `down` (scipy.signal.upfirdn semantics along `axis`;
    other axes batch).  The filtering is one batched kernel-chain
    convolution — the polyphase decomposition is implicit in the
    zero-stuffed operand, which XLA streams without materializing
    per-phase copies."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    x = jnp.moveaxis(put(x), axis, -1)
    hh = np.asarray(h, np.float64)
    if hh.ndim != 1 or hh.size == 0:
        raise ValueError("h must be a nonempty 1-D tap vector")
    n_in = x.shape[-1]
    if up > 1:
        xs = jnp.zeros(x.shape[:-1] + (n_in, up), x.dtype)
        xs = xs.at[..., 0].set(x).reshape(*x.shape[:-1], n_in * up)
    else:
        xs = x
    from godsp_tpu.models.filter import fftconvolve

    full = fftconvolve(xs, hh, mode="full")
    n_out = _upfirdn_len(hh.size, n_in, up, down)
    return jnp.moveaxis(full[..., ::down][..., :n_out], -1, axis)


def decimate(x, q: int, n: int | None = None, ftype: str = "iir",
             axis: int = -1, zero_phase: bool = True) -> jax.Array:
    """Downsample by integer factor q after anti-alias filtering
    (scipy.signal.decimate semantics along `axis`).

    ftype='iir': order-n (default 8) Chebyshev-I lowpass at 0.8/q,
    designed by models.design.cheby1 and run as the parallel-scan SOS
    cascade (sosfiltfilt when zero_phase, else sosfilt).  ftype='fir':
    an n-tap (default 20*q) Hamming firwin lowpass via the polyphase
    path (resample_poly when zero_phase, else upfirdn)."""
    q = int(q)
    if q < 1:
        raise ValueError("q must be >= 1")
    x = put(x)
    x = jnp.moveaxis(x, axis, -1)
    restore = lambda y: jnp.moveaxis(y, -1, axis)
    if ftype == "fir":
        if n is None:
            n = 20 * q
        h = firwin(int(n) + 1, 1.0 / q, window="hamming")
        if zero_phase:
            return restore(resample_poly(x, 1, q, window=h))
        n_in = x.shape[-1]
        n_out = n_in // q + bool(n_in % q)
        return restore(upfirdn(h, x, 1, q)[..., :n_out])
    if ftype != "iir":
        raise ValueError("ftype must be 'iir' or 'fir'")
    from godsp_tpu.models.design import cheby1
    from godsp_tpu.models.iir import sosfilt, sosfiltfilt

    sos = cheby1(8 if n is None else int(n), 0.05, 0.8 / q, output="sos")
    y = sosfiltfilt(sos, x) if zero_phase else sosfilt(sos, x)
    return restore(y[..., ::q])


def resample_poly(x, up: int, down: int, window=("kaiser", 5.0)) -> jax.Array:
    """Polyphase rational-rate resampling (scipy.signal.resample_poly
    with its default zero-padded edges).  window: a firwin window spec
    for the anti-alias lowpass, or an explicit FIR tap array to use
    directly (scipy's array semantics)."""
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    g = gcd(up, down)
    up //= g
    down //= g
    x = put(x)
    if up == 1 and down == 1:
        return x
    n_in = x.shape[-1]
    if n_in == 0:
        raise ValueError("x must have at least one sample")
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)
    if isinstance(window, (np.ndarray, jnp.ndarray, list)):
        h = np.asarray(window, np.float64)
        if h.ndim != 1:
            raise ValueError("an explicit window must be 1-D FIR taps")
        half_len = (h.size - 1) // 2
    else:
        max_rate = max(up, down)
        half_len = 10 * max_rate
        h = firwin(2 * half_len + 1, 1.0 / max_rate, window=window)
    h = h * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    n_post_pad = 0
    while (
        _upfirdn_len(h.size + n_pre_pad + n_post_pad, n_in, up, down)
        < n_out + n_pre_remove
    ):
        n_post_pad += 1
    hf = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    y = upfirdn(hf, x, up, down)
    return y[..., n_pre_remove : n_pre_remove + n_out]
