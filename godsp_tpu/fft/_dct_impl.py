"""Discrete cosine transforms via the framework's FFT kernels.

All eight real trig transforms (DCT/DST types 1-4, scipy.fft
conventions) expressed through the framework's complex FFT: DCT-II by
Makhoul's same-length reorder+phase, DCT-I/DST-I by symmetric/odd
extensions, DCT-IV by a zero-padded 2N FFT with phase twists, and the
DST types by the alternating-sign/reversal relations to their DCT
twins — so power-of-2 sizes take the four-step path and other sizes
Bluestein, with no new kernel code.

  DCT-II:  y[k] = 2 * sum_n x[n] cos(pi k (2n+1) / (2N))
           computed as Re( e^{-i pi k / 2N} * FFT(reorder(x))[k] ) * 2
           where reorder = [x0, x2, ..., x3, x1] (even indices, then
           reversed odd indices — Makhoul's N-point method).
  norm="ortho" matches scipy.fft.dct(..., norm="ortho").

Batched over leading axes, jit-compatible; validated against scipy in
tests/test_fft.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import complex_for, put, real_for
from godsp_tpu.fft.core import _fft_jit, _ifft_jit

__all__ = ["dct", "dctn", "dst", "dstn", "idct", "idctn", "idst", "idstn"]


@lru_cache(maxsize=None)
def _phase(n: int, dtype_name: str) -> np.ndarray:
    """e^{-i pi k / (2N)}, float64-generated."""
    k = np.arange(n, dtype=np.float64)
    return np.exp(-1j * np.pi * k / (2.0 * n)).astype(dtype_name)


@partial(jax.jit, static_argnames=("norm",))
def _dct2_jit(x, norm):
    n = x.shape[-1]
    cdt = complex_for(x.dtype)
    # Makhoul reorder: even indices ascending, odd indices descending.
    v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]], axis=-1)
    V = _fft_jit(v.astype(cdt))
    ph = jnp.asarray(_phase(n, np.dtype(cdt).name))
    y = 2.0 * jnp.real(ph * V)
    if norm == "ortho":
        rdt = x.dtype
        s = jnp.full((n,), 1.0 / jnp.sqrt(2.0 * n), dtype=rdt)
        s = s.at[0].set(1.0 / jnp.sqrt(4.0 * n).astype(rdt))
        y = y * s
    return y


@partial(jax.jit, static_argnames=("norm",))
def _dct3_jit(y, norm):
    n = y.shape[-1]
    rdt = real_for(y.dtype)
    y = jnp.real(y).astype(rdt)
    if norm == "ortho":
        # Undo the forward's ortho scaling, recovering the raw-2x DCT.
        s = jnp.full((n,), jnp.sqrt(2.0 * n), dtype=rdt)
        s = s.at[0].set(jnp.sqrt(4.0 * n).astype(rdt))
        y = y * s
    cdt = complex_for(rdt)
    ph = jnp.asarray(_phase(n, np.dtype(cdt).name))
    # Invert Makhoul: V[k] = conj(phase)[k]... build the complex spectrum
    # of the reordered sequence, inverse FFT, then undo the reorder.
    yk = y.astype(cdt)
    y_rev = jnp.concatenate(
        [jnp.zeros(y.shape[:-1] + (1,), cdt), -yk[..., 1:][..., ::-1] * 1j],
        axis=-1,
    )
    V = (yk + y_rev) / (2.0 * ph)
    v = jnp.real(_ifft_jit(V)).astype(rdt)
    out = jnp.zeros_like(v)
    half = (n + 1) // 2
    out = out.at[..., 0::2].set(v[..., :half])
    out = out.at[..., 1::2].set(v[..., half:][..., ::-1])
    return out


@jax.jit
def _dct1_jit(x):
    """Unnormalized DCT-I: real part of the FFT of the even extension
    [x0..x_{N-1}, x_{N-2}..x1] (length 2N-2)."""
    n = x.shape[-1]
    ext = jnp.concatenate([x, x[..., -2:0:-1]], axis=-1)
    cdt = complex_for(x.dtype)
    return jnp.real(_fft_jit(ext.astype(cdt)))[..., :n].astype(x.dtype)


@lru_cache(maxsize=None)
def _phase4(n: int, dtype_name: str) -> tuple[np.ndarray, np.ndarray]:
    """DCT-IV phases: input twist e^{-i pi n/(2N)} and output twist
    e^{-i pi (2k+1)/(4N)}, float64-generated."""
    m = np.arange(n, dtype=np.float64)
    a = np.exp(-1j * np.pi * m / (2.0 * n)).astype(dtype_name)
    b = np.exp(-1j * np.pi * (2.0 * m + 1.0) / (4.0 * n)).astype(dtype_name)
    return a, b


@jax.jit
def _dct4_jit(x):
    """Unnormalized DCT-IV: y[k] = 2 sum x[n] cos(pi(2n+1)(2k+1)/(4N)),
    one zero-padded 2N-point FFT with pre/post phase twists (pow-2 N
    keeps the kernel path: 2N is pow-2 too)."""
    n = x.shape[-1]
    cdt = complex_for(x.dtype)
    pre, post = _phase4(n, np.dtype(cdt).name)
    v = x.astype(cdt) * jnp.asarray(pre)
    v = jnp.pad(v, [(0, 0)] * (x.ndim - 1) + [(0, n)])
    V = _fft_jit(v)[..., :n]
    return (2.0 * jnp.real(jnp.asarray(post) * V)).astype(x.dtype)


@jax.jit
def _dst1_jit(x):
    """Unnormalized DST-I: -imag of the FFT of the odd extension
    [0, x, 0, -reverse(x)] (length 2N+2), bins 1..N."""
    n = x.shape[-1]
    z = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    ext = jnp.concatenate([z, x, z, -x[..., ::-1]], axis=-1)
    cdt = complex_for(x.dtype)
    return (-jnp.imag(_fft_jit(ext.astype(cdt)))[..., 1 : n + 1]).astype(x.dtype)


def _alt(x):
    """x[n] * (-1)^n (trace-time sign table)."""
    n = x.shape[-1]
    s = np.ones(n)
    s[1::2] = -1.0
    return x * jnp.asarray(s, x.dtype)


def _sqrt2_scale(x, idx: int, up: bool):
    f = np.sqrt(2.0) if up else np.sqrt(0.5)
    return x.at[..., idx].multiply(jnp.asarray(f, x.dtype))


def _cos_sin_transform(x, type: int, norm, sine: bool):
    """Shared DCT/DST driver.  The DST types reduce to the DCT of the
    alternating-sign input with reversed output:
    DST-t(x)[k] = DCT-t((-1)^n x[n])[N-1-k] for t in {2, 4} (and the
    transposed relation for t=3); DST-I has its own odd extension."""
    n = x.shape[-1]
    if not sine:
        if type == 1:
            if n < 2:
                raise ValueError("DCT-I requires at least 2 points")
            if norm == "ortho":
                x = _sqrt2_scale(_sqrt2_scale(x, 0, True), n - 1, True)
            y = _dct1_jit(x)
            if norm == "ortho":
                y = y * jnp.asarray(1.0 / np.sqrt(2.0 * (n - 1)), x.dtype)
                y = _sqrt2_scale(_sqrt2_scale(y, 0, False), n - 1, False)
            return y
        if type == 2:
            return _dct2_jit(x, norm)
        if type == 3:
            # standalone forward DCT-III = 2N * the unnormalized inverse
            if norm == "ortho":
                x = _sqrt2_scale(x, 0, True)
                return _dct3_jit(x, None) * jnp.asarray(
                     2.0 * n / np.sqrt(2.0 * n), x.dtype)
            return _dct3_jit(x, None) * jnp.asarray(2.0 * n, x.dtype)
        y = _dct4_jit(x)
        if norm == "ortho":
            y = y * jnp.asarray(1.0 / np.sqrt(2.0 * n), x.dtype)
        return y
    if type == 1:
        y = _dst1_jit(x)
        if norm == "ortho":
            y = y * jnp.asarray(1.0 / np.sqrt(2.0 * (n + 1)), x.dtype)
        return y
    if type == 2:
        y = _dct2_jit(_alt(x), None)[..., ::-1]
        if norm == "ortho":
            y = y * jnp.asarray(1.0 / np.sqrt(2.0 * n), x.dtype)
            y = _sqrt2_scale(y, n - 1, False)
        return y
    if type == 3:
        if norm == "ortho":
            x = _sqrt2_scale(x, n - 1, True)
            return _alt(_dct3_jit(x[..., ::-1], None)) * jnp.asarray(
                2.0 * n / np.sqrt(2.0 * n), x.dtype)
        return _alt(_dct3_jit(x[..., ::-1], None)) * jnp.asarray(2.0 * n, x.dtype)
    y = _dct4_jit(_alt(x))[..., ::-1]
    if norm == "ortho":
        y = y * jnp.asarray(1.0 / np.sqrt(2.0 * n), x.dtype)
    return y


def _check_transform_args(x, type: int, norm):
    if type not in (1, 2, 3, 4):
        raise ValueError("type must be 1, 2, 3, or 4")
    if norm not in (None, "ortho"):
        raise ValueError(f"unknown norm: {norm}")
    x = put(x)
    if x.dtype.kind == "c":
        raise ValueError("real-input transform expects real input")
    return x


def dct(x, type: int = 2, norm: str | None = None) -> jax.Array:
    """DCT of the trailing axis, types 1-4 (scipy.fft.dct semantics:
    norm=None is the unnormalized 2x convention, "ortho" orthonormal)."""
    x = _check_transform_args(x, type, norm)
    if x.shape[-1] == 0:
        return x
    return _cos_sin_transform(x, int(type), norm, sine=False)


def idct(y, type: int = 2, norm: str | None = None) -> jax.Array:
    """Inverse DCT (scipy.fft.idct): the exact inverse of dct with the
    same type/norm — types 2 and 3 are each other's transposes; types
    1 and 4 are self-inverse up to scaling."""
    y = _check_transform_args(y, type, norm)
    n = y.shape[-1]
    if n == 0:
        return y
    type = int(type)
    if norm == "ortho":
        inv = {1: 1, 2: 3, 3: 2, 4: 4}[type]
        return _cos_sin_transform(y, inv, "ortho", sine=False)
    if type == 2:
        # scipy.fft's backward norm makes idct the exact inverse of dct:
        # idct(dct(x)) == x (the 2N factor is scipy.fftpack semantics).
        return _dct3_jit(y, None)
    if type == 3:
        return _dct2_jit(y, None) * jnp.asarray(0.5 / n, y.dtype)
    if type == 4:
        return _dct4_jit(y) * jnp.asarray(0.5 / n, y.dtype)
    return _dct1_jit(y) * jnp.asarray(0.5 / (n - 1), y.dtype)


def dst(x, type: int = 2, norm: str | None = None) -> jax.Array:
    """DST of the trailing axis, types 1-4 (scipy.fft.dst semantics)."""
    x = _check_transform_args(x, type, norm)
    if x.shape[-1] == 0:
        return x
    return _cos_sin_transform(x, int(type), norm, sine=True)


def idst(y, type: int = 2, norm: str | None = None) -> jax.Array:
    """Inverse DST (scipy.fft.idst): exact inverse of dst with the same
    type/norm."""
    y = _check_transform_args(y, type, norm)
    n = y.shape[-1]
    if n == 0:
        return y
    type = int(type)
    if norm == "ortho":
        inv = {1: 1, 2: 3, 3: 2, 4: 4}[type]
        return _cos_sin_transform(y, inv, "ortho", sine=True)
    inv = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    den = 2.0 * (n + 1) if type == 1 else 2.0 * n
    return _cos_sin_transform(y, inv, None, sine=True) * jnp.asarray(
        1.0 / den, y.dtype)


def _apply_along_axes(fn, x, axes):
    for ax in axes:
        x = jnp.moveaxis(fn(jnp.moveaxis(x, ax, -1)), -1, ax)
    return x


def _norm_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        axes = (axes,)
    out = tuple(int(a) % x.ndim for a in axes)
    if len(set(out)) != len(out):
        raise ValueError("all axes must be unique")
    return out


def dctn(x, type: int = 2, axes=None, norm: str | None = None) -> jax.Array:
    """N-D DCT: the 1-D transform applied over each axis in `axes`
    (scipy.fft.dctn semantics; axes=None -> all)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: dct(v, type, norm), x,
                             _norm_axes(x, axes))


def idctn(x, type: int = 2, axes=None, norm: str | None = None) -> jax.Array:
    """N-D inverse DCT (scipy.fft.idctn)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: idct(v, type, norm), x,
                             _norm_axes(x, axes))


def dstn(x, type: int = 2, axes=None, norm: str | None = None) -> jax.Array:
    """N-D DST (scipy.fft.dstn)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: dst(v, type, norm), x,
                             _norm_axes(x, axes))


def idstn(x, type: int = 2, axes=None, norm: str | None = None) -> jax.Array:
    """N-D inverse DST (scipy.fft.idstn)."""
    x = _check_transform_args(x, type, norm)
    return _apply_along_axes(lambda v: idst(v, type, norm), x,
                             _norm_axes(x, axes))
