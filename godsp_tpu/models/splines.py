"""B-spline filtering and evaluation (scipy.signal spline surface).

Formulation: under scipy's mirror-symmetric (half-sample)
boundary, convolution by the symmetric B-spline kernel is DIAGONAL in
the DCT-II basis — so the spline-coefficient "inverse filter" is one
forward DCT, a pointwise divide, and one inverse DCT through the
framework's FFT kernels, instead of scipy's truncated-precision
forward/backward recursions.  Consequences:

- interior values match scipy's cspline1d/qspline1d to f64 round-off;
- at a few boundary samples of the SMOOTHING path (lamb > 0) scipy's
  truncated initial conditions differ from the exact mirror solution by
  up to ~1e-3 — this module returns the exact solution;
- cspline2d/qspline2d are two separable DCT passes (scipy's own 2-D C
  path is only ~1e-6 accurate by default; this one is exact).

Evaluators reproduce scipy's cspline1d_eval/qspline1d_eval conventions
exactly (reflection of out-of-range points, CLIPPED tap indices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import default_float, put
from godsp_tpu.fft._dct_impl import dct, idct

__all__ = [
    "cspline1d",
    "cspline1d_eval",
    "cspline2d",
    "gauss_spline",
    "qspline1d",
    "qspline1d_eval",
    "qspline2d",
    "spline_filter",
    "symiirorder1",
    "symiirorder2",
]


def gauss_spline(x, n: int) -> jax.Array:
    """Gaussian approximation of the order-n B-spline
    (scipy.signal.gauss_spline): variance (n+1)/12."""
    x = put(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(default_float())
    sig2 = (n + 1) / 12.0
    return jnp.exp(-x * x / (2.0 * sig2)) / jnp.sqrt(2.0 * jnp.pi * sig2)


def _spline_denominator(n: int, kernel_dc: float, kernel_ac: float,
                        lamb: float, dtype) -> jnp.ndarray:
    """Eigenvalues of (B + lamb*D4) under the half-sample-symmetric
    extension, on the DCT-II frequency grid w_k = pi k / n."""
    w = np.pi * np.arange(n, dtype=np.float64) / n
    den = kernel_dc + kernel_ac * np.cos(w)
    if lamb != 0.0:
        den = den + lamb * (2.0 * np.cos(w) - 2.0) ** 2
    return jnp.asarray(den, dtype)


@partial(jax.jit, static_argnames=("dc", "ac", "lamb"))
def _spline_filter_jit(x, dc: float, ac: float, lamb: float):
    den = _spline_denominator(x.shape[-1], dc, ac, lamb, x.dtype)
    return idct(dct(x) / den)


@partial(jax.jit, static_argnames=("dc", "ac", "lamb"))
def _spline_filter2d_jit(x, dc: float, ac: float, lamb: float):
    """Both separable passes in ONE program (no eager transposes)."""
    c = _spline_filter_jit(x, dc, ac, lamb)
    c = jnp.swapaxes(c, -1, -2)
    c = _spline_filter_jit(c, dc, ac, lamb)
    return jnp.swapaxes(c, -1, -2)


def cspline1d(signal, lamb: float = 0.0) -> jax.Array:
    """Cubic-spline coefficients of the trailing axis with
    mirror-symmetric boundary (scipy.signal.cspline1d semantics; the
    lamb > 0 smoothing-spline case solves (B3 + lamb D4) c = x
    exactly).  One DCT round trip; leading axes batch."""
    x = put(signal)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    if x.shape[-1] == 0:
        return x
    if x.shape[-1] == 1:
        return x / (1.0 if lamb == 0.0 else 1.0)
    return _spline_filter_jit(x, 4.0 / 6.0, 2.0 / 6.0, float(lamb))


def qspline1d(signal, lamb: float = 0.0) -> jax.Array:
    """Quadratic-spline coefficients (scipy.signal.qspline1d; smoothing
    is unsupported there too)."""
    if lamb != 0.0:
        raise ValueError("smoothing quadratic splines are not supported "
                         "(scipy.signal.qspline1d raises likewise)")
    x = put(signal)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    if x.shape[-1] <= 1:
        return x
    return _spline_filter_jit(x, 6.0 / 8.0, 2.0 / 8.0, 0.0)


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0) -> jax.Array:
    """2-D cubic-spline coefficients: the separable per-axis filter
    (scipy.signal.cspline2d; `precision` accepted for API parity — the
    DCT route is exact, there is nothing to truncate)."""
    x = put(signal)
    if x.ndim < 2:
        raise ValueError("cspline2d needs a 2-D input")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    if min(x.shape[-2:]) <= 1:
        c = cspline1d(x, lamb)
        return jnp.swapaxes(cspline1d(jnp.swapaxes(c, -1, -2), lamb), -1, -2)
    return _spline_filter2d_jit(x, 4.0 / 6.0, 2.0 / 6.0, float(lamb))


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0) -> jax.Array:
    """2-D quadratic-spline coefficients (scipy.signal.qspline2d)."""
    x = put(signal)
    if x.ndim < 2:
        raise ValueError("qspline2d needs a 2-D input")
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    if min(x.shape[-2:]) <= 1:
        c = qspline1d(x, lamb)
        return jnp.swapaxes(qspline1d(jnp.swapaxes(c, -1, -2), lamb), -1, -2)
    return _spline_filter2d_jit(x, 6.0 / 8.0, 2.0 / 8.0, 0.0)


def spline_filter(Iin, lmbda: float = 5.0) -> jax.Array:
    """Cubic smoothing-spline filter of a 2-D array
    (scipy.signal.spline_filter): coefficients via cspline2d, then the
    B3 reconstruction kernel [1,4,1]/6 along both axes (sepfir2d)."""
    from godsp_tpu.models.conv2d import sepfir2d

    ck = cspline2d(Iin, lmbda)
    h = np.array([1.0, 4.0, 1.0]) / 6.0
    return sepfir2d(ck, h, h)


def _bspline3(t):
    a = jnp.abs(t)
    return jnp.where(
        a < 1.0, 2.0 / 3.0 - a * a + a**3 / 2.0,
        jnp.where(a < 2.0, (2.0 - a) ** 3 / 6.0, 0.0))


def _bspline2(t):
    a = jnp.abs(t)
    return jnp.where(
        a < 0.5, 0.75 - a * a,
        jnp.where(a < 1.5, (a - 1.5) ** 2 / 2.0, 0.0))


@partial(jax.jit, static_argnames=("order",))
def _spline_eval_jit(cj, t, order: int):
    n = cj.shape[0]
    # reflect out-of-range points: |t|, then fold into [0, N-1]
    period = 2.0 * (n - 1)
    t = jnp.abs(t)
    t = jnp.mod(t, period)
    t = jnp.minimum(t, period - t)
    if order == 3:
        jlo = jnp.floor(t - 2.0).astype(jnp.int32) + 1
        taps, basis = 4, _bspline3
    else:
        jlo = jnp.floor(t - 1.5).astype(jnp.int32) + 1
        taps, basis = 3, _bspline2
    res = jnp.zeros_like(t)
    for i in range(taps):
        j = jlo + i
        idx = jnp.clip(j, 0, n - 1)  # scipy's clipped edge taps
        res = res + cj[idx] * basis(t - j.astype(t.dtype))
    return res


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> jax.Array:
    """Evaluate the cubic spline with coefficients cj at points newx
    (scipy.signal.cspline1d_eval: mirror-symmetric reflection outside
    [x0, x0 + dx*(N-1)], clipped edge taps)."""
    cj = put(cj)
    t = (put(newx).astype(cj.dtype) - x0) / float(dx)
    if cj.ndim != 1:
        raise ValueError("cj must be 1-D")
    return _spline_eval_jit(cj, t, 3)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0.0) -> jax.Array:
    """Evaluate the quadratic spline (scipy.signal.qspline1d_eval)."""
    cj = put(cj)
    t = (put(newx).astype(cj.dtype) - x0) / float(dx)
    if cj.ndim != 1:
        raise ValueError("cj must be 1-D")
    return _spline_eval_jit(cj, t, 2)


def symiirorder1(signal, c0: float, z1: float, precision: float = -1.0) -> jax.Array:
    """Symmetric cascade of first-order sections
    c0 / ((1 - z1 z^-1)(1 - z1 z)) with mirror-symmetric boundary
    (scipy.signal.symiirorder1).  Diagonal in the DCT-II basis:
    eigenvalue c0 / (1 - 2 z1 cos w + z1^2) — exact, where scipy's
    recursion truncates its initial sums at `precision` (accepted for
    API parity, nothing to truncate here)."""
    if abs(z1) >= 1.0:
        raise ValueError("|z1| must be < 1 for a stable filter")
    x = put(signal)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    n = x.shape[-1]
    if n <= 1:
        return x * (c0 / (1.0 - z1) ** 2 if n else 1.0)
    w = np.pi * np.arange(n, dtype=np.float64) / n
    gain = c0 / (1.0 - 2.0 * z1 * np.cos(w) + z1 * z1)
    return idct(dct(x) * jnp.asarray(gain, x.dtype))


def symiirorder2(input, r: float, omega: float, precision: float = -1.0) -> jax.Array:
    """Symmetric cascade of second-order sections
    cs^2 / ((1 - 2 r cos(omega) z^-1 + r^2 z^-2)(... z form)) with
    cs = 1 - 2 r cos(omega) + r^2 and mirror-symmetric boundary
    (scipy.signal.symiirorder2) — again one DCT-II round trip with
    eigenvalue cs^2 / |1 - 2 r cos(omega) e^{-iw} + r^2 e^{-2iw}|^2;
    never hits scipy's 'boundary sum did not converge' failure mode."""
    if not 0.0 < r < 1.0:
        raise ValueError("r must lie in (0, 1)")
    x = put(input)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    n = x.shape[-1]
    cs = 1.0 - 2.0 * r * np.cos(omega) + r * r
    if n <= 1:
        return x * (cs * cs / ((1.0 - 2.0 * r * np.cos(omega) + r * r) ** 2)
                    if n else 1.0)
    w = np.pi * np.arange(n, dtype=np.float64) / n
    e = np.exp(-1j * w)
    den = np.abs(1.0 - 2.0 * r * np.cos(omega) * e + (r * r) * e * e) ** 2
    return idct(dct(x) * jnp.asarray(cs * cs / den, x.dtype))
