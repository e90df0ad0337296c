"""Savitzky-Golay smoothing/differentiation (scipy.signal semantics).

The reference has no smoothing surface; production spectral pipelines
use SG filters for baseline removal and derivative estimation.  The
shape: the FIR taps AND the polynomial edge-correction
matrices are closed-form least-squares solutions computed in float64
numpy at trace time (the twiddle-cache discipline), so the device work
is one batched kernel-chain convolution plus two tiny edge matmuls —
no per-window polyfit loops.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import default_float, put

__all__ = ["savgol_coeffs", "savgol_filter"]


def savgol_coeffs(
    window_length: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
    pos=None,
    use: str = "conv",
) -> np.ndarray:
    """FIR taps of a Savitzky-Golay filter (scipy.signal.savgol_coeffs):
    the least-squares degree-`polyorder` polynomial fit over
    `window_length` samples, evaluated (or differentiated `deriv` times)
    at `pos`.  Returns float64 numpy taps — a trace-time constant."""
    window_length = int(window_length)
    polyorder = int(polyorder)
    if polyorder >= window_length:
        raise ValueError("polyorder must be less than window_length")
    halflen, rem = divmod(window_length, 2)
    if pos is None:
        pos = halflen - 0.5 if rem == 0 else halflen
    if not 0 <= pos <= window_length - 1:
        raise ValueError("pos must be nonnegative and less than window_length")
    if use not in ("conv", "dot"):
        raise ValueError("use must be 'conv' or 'dot'")
    if deriv > polyorder:
        return np.zeros(window_length)
    x = np.arange(-pos, window_length - pos, dtype=np.float64)
    if use == "conv":
        x = x[::-1]
    order = np.arange(polyorder + 1).reshape(-1, 1)
    A = x**order  # (polyorder+1, window_length)
    y = np.zeros(polyorder + 1)
    y[deriv] = factorial(deriv) / (delta**deriv)
    coeffs, _, _, _ = np.linalg.lstsq(A, y, rcond=None)
    return coeffs


@lru_cache(maxsize=None)
def _edge_matrices(window_length: int, polyorder: int, deriv: int, delta: float):
    """Trace-time edge-correction operators for mode='interp'.

    scipy fits one degree-`polyorder` polynomial to the first (and last)
    `window_length` samples and replaces the first (last) halflen
    outputs with its derivative values.  That fit-then-evaluate is
    linear in the data: E = V_eval @ pinv(V_fit), a constant
    (halflen, window_length) matrix per edge."""
    halflen = window_length // 2
    t = np.arange(window_length, dtype=np.float64)
    V_fit = np.vander(t, polyorder + 1, increasing=True)  # (W, p+1)
    pinv = np.linalg.pinv(V_fit)
    # derivative of sum c_i t^i evaluated at the edge points
    i = np.arange(polyorder + 1)
    dcoef = np.where(
        i >= deriv,
        np.array([factorial(ii) / factorial(ii - deriv) if ii >= deriv else 0.0 for ii in i]),
        0.0,
    ) / (delta**deriv)
    te = t[:halflen]
    pow_ = np.where((i - deriv) >= 0, i - deriv, 0)
    V_eval = (te[:, None] ** pow_[None, :]) * dcoef[None, :]  # (halflen, p+1)
    E_head = V_eval @ pinv  # (halflen, W)
    # tail: same fit on the LAST window_length samples, evaluated at the
    # last halflen positions t = W-halflen..W-1
    tt = t[window_length - halflen :]
    V_eval_t = (tt[:, None] ** pow_[None, :]) * dcoef[None, :]
    E_tail = V_eval_t @ pinv
    return E_head, E_tail


def savgol_filter(
    x,
    window_length: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
    axis: int = -1,
    mode: str = "interp",
    cval: float = 0.0,
) -> jax.Array:
    """Apply a Savitzky-Golay filter along `axis`
    (scipy.signal.savgol_filter).  mode='interp' (default) fits edge
    polynomials exactly as scipy; 'mirror'/'nearest'/'constant'/'wrap'
    pad then convolve.  One batched device convolution either way."""
    window_length = int(window_length)
    if window_length % 2 == 0 and mode == "interp":
        raise ValueError("window_length must be odd for mode='interp'")
    if mode not in ("interp", "mirror", "nearest", "constant", "wrap"):
        raise ValueError(
            "mode must be 'interp', 'mirror', 'nearest', 'constant', or 'wrap'"
        )
    taps = savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    x = put(x)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    halflen = window_length // 2
    if mode == "interp":
        if window_length > n:
            raise ValueError(
                "If mode is 'interp', window_length must be less than or "
                "equal to the size of x"
            )
        from godsp_tpu.models.filter import fftconvolve

        y = fftconvolve(x, jnp.asarray(taps, x.dtype), mode="same")
        E_head, E_tail = _edge_matrices(
            window_length, int(polyorder), int(deriv), float(delta)
        )
        Eh = jnp.asarray(E_head, x.dtype)
        Et = jnp.asarray(E_tail, x.dtype)
        hi = jax.lax.Precision.HIGHEST  # no TF32 on GPUs
        head = jnp.einsum("ij,...j->...i", Eh, x[..., :window_length], precision=hi)
        tail = jnp.einsum(
            "ij,...j->...i", Et, x[..., n - window_length :], precision=hi
        )
        y = jnp.concatenate([head, y[..., halflen : n - halflen], tail], axis=-1)
        return jnp.moveaxis(y, -1, axis)
    # padded modes: extend by halflen each side, convolve 'valid'-style
    pad = halflen
    if mode == "mirror":
        head = x[..., pad:0:-1]
        tail = x[..., -2 : -pad - 2 : -1]
    elif mode == "nearest":
        head = jnp.repeat(x[..., :1], pad, axis=-1)
        tail = jnp.repeat(x[..., -1:], pad, axis=-1)
    elif mode == "wrap":
        head = x[..., -pad:]
        tail = x[..., :pad]
    else:  # constant
        head = jnp.full(x.shape[:-1] + (pad,), cval, x.dtype)
        tail = jnp.full(x.shape[:-1] + (pad,), cval, x.dtype)
    ext = jnp.concatenate([head, x, tail], axis=-1)
    from godsp_tpu.models.filter import fftconvolve

    full = fftconvolve(ext, jnp.asarray(taps, x.dtype), mode="full")
    y = full[..., 2 * pad : 2 * pad + n]
    return jnp.moveaxis(y, -1, axis)
