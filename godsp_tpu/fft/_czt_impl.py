"""Chirp-z transform on an arbitrary spiral contour + zoom FFT.

Generalizes the Bluestein machinery (fft/bluestein.py, reference
fft/bluestein.go) from "DFT at any length" to scipy.signal's czt/
zoom_fft surface: X[k] = sum_n x[n] a^{-n} w^{nk}, k in [0, m) — the
DFT when a=1, w=exp(-2*pi*i/m); a zoomed frequency band when w steps a
sub-interval of the unit circle; Laplace-style spiral contours when
|w| != 1.

Same shape as Bluestein: all chirp tables are float64 numpy constants
built at trace time (cached per geometry), and the one convolution runs
through pow2_circular_filter with the 1/L inverse normalization folded
into the filter.
The unit-circle default uses exact (k^2 mod 2m) reduction like
fft/bluestein.py; explicit contours follow scipy's w**(k^2/2) float64
semantics (their precision decays identically, keeping parity).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import complex_for, put
from godsp_tpu.dsputils.utils import next_power_of_2
from godsp_tpu.fft.pow2 import pow2_circular_filter

__all__ = ["CZT", "ZoomFFT", "czt", "czt_points", "zoom_fft"]


def _chain_tables(n: int, m: int, wk2: np.ndarray, ak: np.ndarray):
    """Package the shifted-filter convolution form (scipy _czt layout):
    premultiplier A[k] = a^-k w^(k^2/2) (length n), filter
    b = 1 / [w^((n-1)^2/2) .. w^(1/2), w^(0) .. w^((m-1)^2/2)] placed so
    the linear-convolution window sits at [n-1, n+m-1), and the
    postmultiplier w^(k^2/2) (length m)."""
    la = next_power_of_2(n + m - 1)
    b = np.zeros(la, np.complex128)
    filt = 1.0 / np.hstack((wk2[n - 1 : 0 : -1], wk2[:m]))
    b[: filt.shape[0]] = filt
    return ak * wk2[:n], wk2[:m], np.fft.fft(b), la


@lru_cache(maxsize=None)
def _czt_tables(n: int, m: int, w: Optional[complex], a: complex):
    k = np.arange(max(m, n), dtype=np.float64)
    if w is None:
        # FFT-like default: exact k^2 mod 2m reduction (bluestein.py).
        kexact = [(int(v) * int(v)) % (2 * m) for v in range(max(m, n))]
        wk2 = np.exp(-1j * np.pi * np.asarray(kexact, np.float64) / m)
    else:
        wk2 = np.asarray(w, np.complex128) ** (k**2 / 2.0)
    ak = np.asarray(a, np.complex128) ** -k[:n]
    return _chain_tables(n, m, wk2, ak)


@lru_cache(maxsize=None)
def _zoom_tables(n: int, m: int, f1: float, f2: float, fs: float,
                 endpoint: bool):
    # scipy.signal.ZoomFFT: phases built from the frequency step
    # directly (not via a w power), endpoint semantics included.
    k = np.arange(max(m, n), dtype=np.float64)
    scale = ((f2 - f1) * m) / (fs * (m - 1)) if endpoint else (f2 - f1) / fs
    wk2 = np.exp(-1j * np.pi * scale * k**2 / m)
    ak = np.exp(-2j * np.pi * f1 / fs * k[:n])
    return _chain_tables(n, m, wk2, ak)


def _czt_apply(x: jax.Array, tables) -> jax.Array:
    """Chain body; runs under jit, so the trace-time numpy tables embed
    as constants."""
    pre_np, post_np, fft_b_np, la = tables
    n = x.shape[-1]
    m = post_np.shape[0]
    cdtype = complex_for(x.dtype)
    u = x.astype(cdtype) * jnp.asarray(pre_np, cdtype)
    u = jnp.pad(u, [(0, 0)] * (x.ndim - 1) + [(0, la - n)])
    conv = pow2_circular_filter(
        u, jnp.asarray(fft_b_np, cdtype), scale=1.0 / la
    )
    # The circular result equals the linear convolution on the window
    # [n-1, n+m-1) because la >= n+m-1 pushes every aliased term below
    # index n-1.
    return conv[..., n - 1 : n + m - 1] * jnp.asarray(post_np, cdtype)


@lru_cache(maxsize=None)
def _czt_chain_jit(n: int, m: int, w: Optional[complex], a: complex):
    tables = _czt_tables(n, m, w, a)
    return jax.jit(lambda x: _czt_apply(x, tables))


@lru_cache(maxsize=None)
def _zoom_chain_jit(n: int, m: int, f1: float, f2: float, fs: float,
                    endpoint: bool):
    tables = _zoom_tables(n, m, f1, f2, fs, endpoint)
    return jax.jit(lambda x: _czt_apply(x, tables))


def czt(x, m: Optional[int] = None, w: Optional[complex] = None,
        a: complex = 1 + 0j) -> jax.Array:
    """Chirp-z transform of the trailing axis (scipy.signal.czt).

    X[k] = sum_n x[n] a^{-n} w^{nk}, k in [0, m).  Defaults: m = N,
    w = exp(-2*pi*i/m) (= the DFT; czt(x) == fft(x) for a=1), a = 1.
    Batched over leading axes; m and the contour are trace-time
    constants.

    Numerical note (shared with scipy.signal.czt): contours far off the
    unit circle are inherently ill-conditioned — the chirp tables span
    |w|^(k^2/2), so e.g. |w| = e^-0.1 at n = 64 already swings ~e^198
    and cancels catastrophically.  Keep |log|w|| * max(n, m)^2 / 2
    within float64 range (mild spirals are fine; verified ~290 dB vs
    direct evaluation at |w| = e^-0.001).
    """
    x = put(x)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("czt requires at least one input point")
    m = n if m is None else m
    if m < 1:
        raise ValueError("m must be >= 1")
    wkey = None if w is None else complex(w)
    if wkey is not None and wkey == 0:
        raise ValueError("w must be nonzero")
    return _czt_chain_jit(n, m, wkey, complex(a))(x)


def zoom_fft(x, fn, m: Optional[int] = None, fs: float = 2.0,
             endpoint: bool = False) -> jax.Array:
    """Zoomed DFT over the band [f1, f2] (scipy.signal.zoom_fft).

    fn: [f1, f2], or a scalar for [0, fn].  Evaluates m points (default
    N) at linspace(f1, f2, m, endpoint=endpoint) in units of fs —
    a band-limited slice of the spectrum without computing the full FFT.
    zoom_fft(x, 2) == fft(x) for real-frequency conventions (fs=2).
    """
    x = put(x)
    n = x.shape[-1]
    if n < 1:
        raise ValueError("zoom_fft requires at least one input point")
    fn = np.atleast_1d(np.asarray(fn, np.float64))
    if fn.size == 2:
        f1, f2 = float(fn[0]), float(fn[1])
    elif fn.size == 1:
        f1, f2 = 0.0, float(fn[0])
    else:
        raise ValueError("fn must be a scalar or a 2-element sequence")
    m = n if m is None else m
    if m < 1 or (endpoint and m < 2):
        raise ValueError("m must be >= 1 (>= 2 with endpoint=True)")
    return _zoom_chain_jit(n, m, f1, f2, float(fs), bool(endpoint))(x)


class CZT:
    """Callable chirp-z plan (scipy.signal.CZT surface): fixes (n, m, w,
    a) so the chirp/convolution tables are built once and every call is
    a single kernel-chain launch on a new signal."""

    def __init__(self, n: int, m: Optional[int] = None,
                 w: Optional[complex] = None, a: complex = 1 + 0j):
        n = int(n)
        if n < 1:
            raise ValueError("n must be >= 1")
        m = n if m is None else int(m)
        if m < 1:
            raise ValueError("m must be >= 1")
        wkey = None if w is None else complex(w)
        if wkey is not None and wkey == 0:
            raise ValueError("w must be nonzero")
        self.n, self.m = n, m
        self.w = wkey if wkey is not None else np.exp(-2j * np.pi / m)
        self.a = complex(a)
        self._chain = _czt_chain_jit(n, m, wkey, complex(a))

    def __call__(self, x) -> jax.Array:
        x = put(x)
        if x.shape[-1] != self.n:
            raise ValueError(f"signal length must be {self.n}")
        return self._chain(x)

    def points(self) -> np.ndarray:
        """The m contour points a * w^-k (scipy.signal.CZT.points)."""
        return self.a * self.w ** -np.arange(self.m)


class ZoomFFT(CZT):
    """Callable zoomed-DFT plan (scipy.signal.ZoomFFT surface): fixes
    (n, band, m, fs) so repeated band analyses reuse the tables."""

    def __init__(self, n: int, fn, m: Optional[int] = None, *,
                 fs: float = 2.0, endpoint: bool = False):
        n = int(n)
        if n < 1:
            raise ValueError("n must be >= 1")
        fn = np.atleast_1d(np.asarray(fn, np.float64))
        if fn.size == 2:
            f1, f2 = float(fn[0]), float(fn[1])
        elif fn.size == 1:
            f1, f2 = 0.0, float(fn[0])
        else:
            raise ValueError("fn must be a scalar or a 2-element sequence")
        m = n if m is None else int(m)
        if m < 1 or (endpoint and m < 2):
            raise ValueError("m must be >= 1 (>= 2 with endpoint=True)")
        self.n, self.m = n, m
        self.f1, self.f2, self.fs = f1, f2, float(fs)
        step = (f2 - f1) / ((m - 1) if endpoint else m)
        self.w = np.exp(-2j * np.pi * step / float(fs))
        self.a = np.exp(2j * np.pi * f1 / float(fs))
        self._chain = _zoom_chain_jit(n, m, f1, f2, float(fs),
                                      bool(endpoint))


def czt_points(m: int, w: Optional[complex] = None,
               a: complex = 1 + 0j) -> np.ndarray:
    """The m chirp-z contour points a * w^-k (scipy.signal.czt_points;
    w defaults to the unit-circle DFT spacing exp(-2j pi/m))."""
    m = int(m)
    if m < 1:
        raise ValueError("m must be >= 1")
    w = np.exp(-2j * np.pi / m) if w is None else complex(w)
    return complex(a) * w ** -np.arange(m)
