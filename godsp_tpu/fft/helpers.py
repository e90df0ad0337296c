"""Frequency-grid and spectrum-layout helpers (numpy.fft-compatible).

Beyond the reference's surface (go-dsp exposes only the freqs grid
inside Pwelch, pwelch.go:138-142) but expected of any FFT package:
sample-frequency grids and the centered-spectrum reorder, plus the
analytic signal (Hilbert transform) built on the framework's FFT stack.
All batched over leading axes and jit-compatible.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import as_real_array, default_float, put

__all__ = ["fftfreq", "rfftfreq", "fftshift", "ifftshift", "hfft",
           "hfft2", "hfftn", "hilbert", "ihfft", "ihfft2", "ihfftn",
           "irfft", "irfft2", "irfftn",
           "next_fast_len", "prev_fast_len", "rfft", "rfft2", "rfftn"]


def fftfreq(n: int, d: float = 1.0) -> jax.Array:
    """DFT sample frequencies: [0, 1, ..., n//2-1, -(n//2), ..., -1]/(n d)
    (numpy.fft.fftfreq; the two-sided counterpart of pwelch.go:138-142)."""
    f = default_float()
    k = np.fft.fftfreq(n, d).astype(np.float64)
    return jnp.asarray(k, dtype=f)


def rfftfreq(n: int, d: float = 1.0) -> jax.Array:
    """One-sided DFT sample frequencies i/(n d), i = 0..n//2 — exactly
    Pwelch's freqs grid (pwelch.go:138-142) with fs = 1/d."""
    f = default_float()
    return jnp.arange(n // 2 + 1, dtype=f) / (n * d)


@partial(jax.jit, static_argnames=("axes",))
def _fftshift_jit(x, axes):
    return jnp.fft.fftshift(x, axes=axes)


@partial(jax.jit, static_argnames=("axes",))
def _ifftshift_jit(x, axes):
    return jnp.fft.ifftshift(x, axes=axes)


def _shift_axes(axes):
    return tuple(axes) if isinstance(axes, (list, tuple)) else axes


def fftshift(x, axes=None) -> jax.Array:
    """Move the zero-frequency bin to the center (numpy.fft.fftshift)."""
    return _fftshift_jit(put(x), _shift_axes(axes))


def ifftshift(x, axes=None) -> jax.Array:
    """Inverse of fftshift, exact also for odd lengths."""
    return _ifftshift_jit(put(x), _shift_axes(axes))


def hilbert(x, N: int | None = None, axis: int = -1) -> jax.Array:
    """Analytic signal of a real input (scipy.signal.hilbert semantics,
    incl. the N zero-pad/truncate and axis parameters).

    z = x + i * H{x}: the spectrum's positive frequencies are doubled,
    negative zeroed (DC and Nyquist kept), through the framework's FFT
    dispatch (fft/pow2.py for power-of-2 lengths, else Bluestein).
    |z| is the envelope; jnp.angle(z) the instantaneous phase.
    """
    from godsp_tpu.fft.core import fft, ifft

    x = as_real_array(x)
    x = jnp.moveaxis(x, axis, -1)
    if N is not None:
        N = int(N)
        if N < 1:
            raise ValueError("N must be >= 1")
        cur = x.shape[-1]
        if N < cur:
            x = x[..., :N]
        elif N > cur:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, N - cur)])
    n = x.shape[-1]
    if n == 0:
        from godsp_tpu._dtypes import complex_for

        return x.astype(complex_for(x.dtype))
    X = fft(x)
    h = np.zeros(n, dtype=np.float64)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[1 : (n + 1) // 2] = 2.0
    return jnp.moveaxis(ifft(X * jnp.asarray(h, dtype=X.real.dtype)), -1, axis)


@partial(jax.jit, static_argnames=("n",))
def _rfft_jit(x, n: int):
    from godsp_tpu.fft.core import _fft_jit

    cur = x.shape[-1]
    if n < cur:
        x = x[..., :n]
    elif n > cur:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - cur)])
    return _fft_jit(x, axis=-1)[..., : n // 2 + 1]


def rfft(x, n: int | None = None, axis: int = -1) -> jax.Array:
    """One-sided FFT of real input (scipy.fft.rfft semantics: n//2 + 1
    bins; n pads/truncates before transforming).  The
    resize/transform/slice run as one program."""
    x = put(x)
    if x.dtype.kind == "c":
        raise ValueError("rfft expects real input")
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1] if n is None else int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    return jnp.moveaxis(_rfft_jit(x, n), -1, axis)


@partial(jax.jit, static_argnames=("n",))
def _irfft_jit(X, n: int):
    from godsp_tpu.fft.core import _ifft_jit

    nb = n // 2 + 1
    if X.shape[-1] < nb:
        X = jnp.pad(X, [(0, 0)] * (X.ndim - 1) + [(0, nb - X.shape[-1])])
    else:
        X = X[..., :nb]
    neg = jnp.conj(X[..., 1 : (n + 1) // 2][..., ::-1])
    return jnp.real(_ifft_jit(jnp.concatenate([X, neg], axis=-1)))


def irfft(X, n: int | None = None, axis: int = -1) -> jax.Array:
    """Real inverse of rfft (scipy.fft.irfft: output length n, default
    2*(bins-1)); Hermitian rebuild + inverse as one program."""
    from godsp_tpu._dtypes import as_complex_array

    X = put(X)
    X = jnp.moveaxis(as_complex_array(X), axis, -1)
    n = 2 * (X.shape[-1] - 1) if n is None else int(n)
    if n < 1:
        raise ValueError("n must be >= 1")
    return jnp.moveaxis(_irfft_jit(X, n), -1, axis)


def hfft(x, n: int | None = None, axis: int = -1) -> jax.Array:
    """FFT of a Hermitian-symmetric signal -> real spectrum
    (scipy.fft.hfft): hfft(x, n) == irfft(conj(x), n) * n."""
    from godsp_tpu._dtypes import as_complex_array

    x = jnp.conj(as_complex_array(put(x)))
    bins = x.shape[axis]
    n = 2 * (bins - 1) if n is None else int(n)
    return irfft(x, n, axis=axis) * n


def ihfft(x, n: int | None = None, axis: int = -1) -> jax.Array:
    """Inverse of hfft (scipy.fft.ihfft): conj(rfft(x, n)) / n."""
    x = put(x)
    if x.dtype.kind == "c":
        raise ValueError("ihfft expects real input")
    nn = x.shape[axis] if n is None else int(n)
    return jnp.conj(rfft(x, n, axis=axis)) / nn


def _smooth_search(target: int, primes, prev: bool) -> int:
    """Enumerate products of the odd primes (any multiplicity), filling
    with the power of two that lands nearest target on the requested
    side; returns the best 'smooth' length."""
    if prev:
        best = 1

        def rec(prod):
            nonlocal best
            if prod > target:
                return
            quot = target // prod
            if quot >= 1:
                p2 = 1 << (quot.bit_length() - 1)
                best = max(best, p2 * prod)
            for q in primes:
                if prod * q > target:
                    break
                rec(prod * q)

        rec(1)
        return best
    best = 1 << (target - 1).bit_length()

    def rec(prod):
        nonlocal best
        if prod >= best:
            return
        quot = -(-target // prod)
        p2 = 1 << max(quot - 1, 0).bit_length()
        n = p2 * prod
        if n < best:
            best = n
        for q in primes:
            if prod * q >= best:
                break
            rec(prod * q)

    rec(1)
    return best


def next_fast_len(target: int, real: bool = False) -> int:
    """Smallest FFT-fast length >= target (scipy.fft.next_fast_len:
    {2,3,5,7,11}-smooth for complex transforms, {2,3,5}-smooth for
    real=True).  Note: this framework's fast sizes are powers of two
    (non-powers take Bluestein) — use dsputils.next_power_of_2 when
    padding for speed; this helper exists for scipy-compatible
    planning."""
    target = int(target)
    if target <= 1:
        return max(target, 1)
    primes = (3, 5) if real else (3, 5, 7, 11)
    return _smooth_search(target, primes, prev=False)


def prev_fast_len(target: int, real: bool = False) -> int:
    """Largest FFT-fast length <= target (scipy.fft.prev_fast_len)."""
    target = int(target)
    if target < 1:
        raise ValueError("target must be >= 1")
    primes = (3, 5) if real else (3, 5, 7, 11)
    return _smooth_search(target, primes, prev=True)


def rfft2(x, s=None, axes=(-2, -1)) -> jax.Array:
    """2-D FFT of real input, one-sided over the last transform axis
    (scipy.fft.rfft2 semantics)."""
    return rfftn(x, s=s, axes=axes)


def irfft2(X, s=None, axes=(-2, -1)) -> jax.Array:
    """Inverse of rfft2 (scipy.fft.irfft2)."""
    return irfftn(X, s=s, axes=axes)


def rfftn(x, s=None, axes=None) -> jax.Array:
    """N-D FFT of real input, one-sided over the LAST axis in `axes`
    (scipy.fft.rfftn): rfft along the final transform axis, then full
    complex FFTs along the rest."""
    from godsp_tpu.fft.core import fft as _cfft

    x = put(x)
    if x.dtype.kind == "c":
        raise ValueError("rfftn expects real input")
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes)
    if len(s) != len(axes):
        raise ValueError("s must match axes")
    X = rfft(x, int(s[-1]), axis=axes[-1])
    for ax, n in zip(axes[:-1], s[:-1]):
        n = int(n)
        cur = X.shape[ax]
        Xm = jnp.moveaxis(X, ax, -1)
        if n < cur:
            Xm = Xm[..., :n]
        elif n > cur:
            Xm = jnp.pad(Xm, [(0, 0)] * (Xm.ndim - 1) + [(0, n - cur)])
        X = jnp.moveaxis(_cfft(Xm), -1, ax)
    return X


def irfftn(X, s=None, axes=None) -> jax.Array:
    """Inverse of rfftn (scipy.fft.irfftn): full inverse FFTs on the
    leading transform axes, then the real inverse along the last."""
    from godsp_tpu._dtypes import as_complex_array
    from godsp_tpu.fft.core import ifft as _cifft

    X = as_complex_array(put(X))
    if axes is None:
        axes = tuple(range(X.ndim))
    axes = tuple(int(a) % X.ndim for a in axes)
    if s is None:
        s = tuple(X.shape[a] for a in axes[:-1]) + (
            2 * (X.shape[axes[-1]] - 1),)
    if len(s) != len(axes):
        raise ValueError("s must match axes")
    for ax, n in zip(axes[:-1], s[:-1]):
        n = int(n)
        cur = X.shape[ax]
        Xm = jnp.moveaxis(X, ax, -1)
        if n < cur:
            Xm = Xm[..., :n]
        elif n > cur:
            Xm = jnp.pad(Xm, [(0, 0)] * (Xm.ndim - 1) + [(0, n - cur)])
        X = jnp.moveaxis(_cifft(Xm), -1, ax)
    return irfft(X, int(s[-1]), axis=axes[-1])


def ihfftn(x, s=None, axes=None) -> jax.Array:
    """N-D inverse Hermitian FFT of real input (scipy.fft.ihfftn):
    conj(rfftn(x, s, axes)) / prod(transform lengths)."""
    x = put(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes)
    size = 1
    for n in s:
        size *= int(n)
    return jnp.conj(rfftn(x, s=s, axes=axes)) / size


def ihfft2(x, s=None, axes=(-2, -1)) -> jax.Array:
    """2-D inverse Hermitian FFT (scipy.fft.ihfft2)."""
    return ihfftn(x, s=s, axes=axes)


def hfftn(x, s=None, axes=None) -> jax.Array:
    """N-D FFT of a Hermitian-symmetric signal -> real spectrum
    (scipy.fft.hfftn): irfftn(conj(x), s, axes) * prod(output
    transform lengths)."""
    from godsp_tpu._dtypes import as_complex_array

    x = jnp.conj(as_complex_array(put(x)))
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if s is None:
        s = tuple(x.shape[a] for a in axes[:-1]) + (
            2 * (x.shape[axes[-1]] - 1),)
    out = irfftn(x, s=s, axes=axes)
    size = 1
    for n in s:
        size *= int(n)
    return out * size


def hfft2(x, s=None, axes=(-2, -1)) -> jax.Array:
    """2-D Hermitian FFT (scipy.fft.hfft2)."""
    return hfftn(x, s=s, axes=axes)
