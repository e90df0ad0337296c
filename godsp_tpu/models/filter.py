"""Linear convolution and FIR filtering on the FFT convolution chain.

The reference stops at circular `Convolve` (fft/fft.go:55-69); production
DSP needs LINEAR convolution and long-signal FIR filtering.  Built on the
framework's FFT convolution chain (fft/pow2.py):

  fftconvolve  — scipy-style linear convolution (full/same/valid) via
                 zero-padding to a kernel-eligible power of 2;
  fir_filter   — causal FIR y[n] = sum_k taps[k] x[n-k], zero initial
                 state (scipy.signal.lfilter(taps, 1, x) semantics);
  overlap_save — block-wise FIR for long signals: all blocks are batched
                 into ONE kernel-chain launch with the tap spectrum
                 precomputed, so arbitrarily long signals filter at the
                 batched-FFT rate with O(block) memory per lane.

All functions are batched over leading axes and jit-compatible.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import as_complex_array, complex_for, put, real_for
from godsp_tpu.dsputils.utils import next_power_of_2
from godsp_tpu.fft.core import fft
from godsp_tpu.fft.pow2 import pow2_circular_filter, pow2_convolve, pow2_fft

__all__ = [
    "choose_conv_method",
    "convolve",
    "correlate",
    "correlation_lags",
    "deconvolve",
    "envelope",
    "fftconvolve",
    "fir_filter",
    "medfilt",
    "oaconvolve",
    "overlap_save",
]


def _out_slice(full: jax.Array, la: int, lb: int, mode: str) -> jax.Array:
    lfull = la + lb - 1
    if mode == "full":
        return full[..., :lfull]
    if mode == "same":
        start = (lb - 1) // 2
        return full[..., start : start + la]
    if mode == "valid":
        lo, hi = min(la, lb), max(la, lb)
        return full[..., lo - 1 : lo - 1 + hi - lo + 1]
    raise ValueError(f"unknown mode: {mode}")


@partial(jax.jit, static_argnames=("mode", "real_out"))
def _fftconvolve_jit(a, b, mode: str, real_out: bool):
    la, lb = a.shape[-1], b.shape[-1]
    n = next_power_of_2(la + lb - 1)
    pad_a = [(0, 0)] * (a.ndim - 1) + [(0, n - la)]
    pad_b = [(0, 0)] * (b.ndim - 1) + [(0, n - lb)]
    ac = jnp.pad(as_complex_array(a), pad_a)
    bc = jnp.pad(as_complex_array(b), pad_b)
    full = pow2_convolve(ac, bc, scale=1.0 / n)
    out = _out_slice(full, la, lb, mode)
    return jnp.real(out) if real_out else out


@partial(jax.jit, static_argnames=("mode", "real_out", "axes"))
def _fftconvolve_nd_jit(a, b, mode: str, real_out: bool, axes: tuple):
    """scipy-style N-D convolution over `axes`: per-axis pow-2 pad +
    forward FFT passes, one pointwise product, inverse passes, then the
    per-axis mode crop."""
    ac = as_complex_array(a)
    bc = as_complex_array(b)
    sizes = []
    for ax in axes:
        la, lb = a.shape[ax], b.shape[ax]
        n = next_power_of_2(la + lb - 1)
        sizes.append((la, lb, n))
        pad_a = [(0, 0)] * ac.ndim
        pad_a[ax] = (0, n - la)
        pad_b = [(0, 0)] * bc.ndim
        pad_b[ax] = (0, n - lb)
        ac = jnp.moveaxis(pow2_fft(jnp.moveaxis(jnp.pad(ac, pad_a), ax, -1)),
                          -1, ax)
        bc = jnp.moveaxis(pow2_fft(jnp.moveaxis(jnp.pad(bc, pad_b), ax, -1)),
                          -1, ax)
    full = ac * bc
    scale = 1.0
    for (_, _, n) in sizes:
        scale *= n
    for ax in axes:
        full = jnp.moveaxis(
            pow2_fft(jnp.moveaxis(full, ax, -1), inverse=True), -1, ax)
    full = full * (1.0 / scale)
    for ax, (la, lb, _) in zip(axes, sizes):
        sl = [slice(None)] * full.ndim
        if mode == "full":
            sl[ax] = slice(0, la + lb - 1)
        elif mode == "same":
            start = (lb - 1) // 2
            sl[ax] = slice(start, start + la)
        else:
            lo, hi = min(la, lb), max(la, lb)
            sl[ax] = slice(lo - 1, lo - 1 + hi - lo + 1)
        full = full[tuple(sl)]
    return jnp.real(full) if real_out else full


def fftconvolve(a, b, mode: str = "full", axes=None) -> jax.Array:
    """Linear convolution of a and b.

    Default (axes=None): scipy.signal.fftconvolve semantics on the 1-D
    TRAILING axis with leading axes broadcast as batch (this framework's
    batched convention).  With `axes` given: scipy's N-D semantics —
    convolve over exactly those axes (the remaining axes must agree or
    broadcast), e.g. axes=(-2, -1) for image convolution.

    Real inputs return real output.  mode: "full" (la+lb-1), "same"
    (size of a), "valid" (|la-lb|+1) — applied per convolved axis.
    """
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unknown mode: {mode}")
    a = put(a)
    b = put(b)
    real_out = a.dtype.kind != "c" and b.dtype.kind != "c"
    if axes is not None:
        if isinstance(axes, int):
            axes = (axes,)
        nd = max(a.ndim, b.ndim)
        axes = tuple(sorted(ax % nd for ax in axes))
        if len(set(axes)) != len(axes):
            raise ValueError("axes must be unique")
        a = a.reshape((1,) * (nd - a.ndim) + a.shape)
        b = b.reshape((1,) * (nd - b.ndim) + b.shape)
        for ax in axes:
            if a.shape[ax] == 0 or b.shape[ax] == 0:
                raise ValueError("empty input")
            if mode == "valid" and a.shape[ax] < b.shape[ax]:
                raise ValueError("valid mode needs a at least as large as b "
                                 "along every convolved axis")
        return _fftconvolve_nd_jit(a, b, mode, real_out, axes)
    if a.shape[-1] == 0 or b.shape[-1] == 0:
        raise ValueError("empty input")
    return _fftconvolve_jit(a, b, mode, real_out)


def correlate(a, b, mode: str = "full", axes=None) -> jax.Array:
    """Cross-correlation of a and b (scipy.signal.correlate, method='fft',
    1-D trailing axes; leading axes broadcast as batch): correlate(a, b)
    [k] = sum_n a[n + k - (lb - 1)] conj(b[n]).  Equivalent to linear
    convolution with the reversed conjugate of b — one kernel-chain
    launch via fftconvolve.  With `axes` given, correlates over those
    axes (N-D, like fftconvolve's axes)."""
    b = put(b)
    if axes is None:
        rev = jnp.conj(b[..., ::-1]) if b.dtype.kind == "c" else b[..., ::-1]
        return fftconvolve(a, rev, mode=mode)
    ax_t = (axes,) if isinstance(axes, int) else tuple(axes)
    sl = [slice(None)] * b.ndim
    for ax in ax_t:
        sl[ax % b.ndim] = slice(None, None, -1)
    rev = b[tuple(sl)]
    if b.dtype.kind == "c":
        rev = jnp.conj(rev)
    return fftconvolve(a, rev, mode=mode, axes=ax_t)


def correlation_lags(in1_len: int, in2_len: int, mode: str = "full") -> jax.Array:
    """Lag indices for correlate's output (scipy.signal.correlation_lags):
    lags[k] such that correlate(a, b)[k] pairs a[n + lags[k]] with b[n]."""
    in1_len, in2_len = int(in1_len), int(in2_len)
    if mode == "full":
        return jnp.arange(-in2_len + 1, in1_len)
    if mode == "same":
        lags = jnp.arange(-in2_len + 1, in1_len)
        mid = lags.shape[0] // 2
        start = mid - in1_len // 2
        return lags[start : start + in1_len]
    if mode == "valid":
        bound = in1_len - in2_len
        return jnp.arange(bound + 1) if bound >= 0 else jnp.arange(bound, 1)
    raise ValueError(f"unknown mode: {mode}")


def deconvolve(signal, divisor):
    """Polynomial long division: (quotient, remainder) such that
    signal = convolve(divisor, quotient) + remainder
    (scipy.signal.deconvolve semantics; host float64/complex128 — the
    sequential recurrence is division, not a batched device op)."""
    import numpy as np

    num = np.atleast_1d(np.asarray(signal))
    den = np.atleast_1d(np.asarray(divisor))
    if num.ndim != 1 or den.ndim != 1:
        raise ValueError("signal and divisor must be 1-D")
    if den.shape[0] == 0 or den[0] == 0:
        raise ValueError("divisor must not be empty or start with zero")
    dt = np.result_type(num.dtype, den.dtype, np.float64)
    num = num.astype(dt)
    den = den.astype(dt)
    N, D = num.shape[0], den.shape[0]
    if D > N:
        return np.zeros(0, dt), num
    quot = np.zeros(N - D + 1, dt)
    rem = num.copy()
    for i in range(N - D + 1):
        c = rem[i] / den[0]
        quot[i] = c
        rem[i : i + D] -= c * den
    return quot, rem


@partial(jax.jit, static_argnames=("k",))
def _medfilt_jit(x, k: int):
    pad = k // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    idx = jnp.arange(x.shape[-1])[:, None] + jnp.arange(k)[None, :]
    frames = jnp.take(xp, idx, axis=-1)  # (..., n, k)
    return jnp.median(frames, axis=-1)


def medfilt(x, kernel_size: int = 3) -> jax.Array:
    """Sliding-window median along the trailing axis with zero-padded
    edges (scipy.signal.medfilt's 1-D behavior; leading axes batch).
    The window axis is materialized and reduced with jnp.median — a
    sort over a static tiny axis, which XLA vectorizes across lanes."""
    from godsp_tpu._dtypes import default_float

    k = int(kernel_size)
    if k < 1 or k % 2 == 0:
        raise ValueError("kernel_size must be a positive odd integer")
    x = put(x)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(default_float())
    return _medfilt_jit(x, k)


def fir_filter(x, taps) -> jax.Array:
    """Causal FIR filter with zero initial state: y has x's length,
    y[n] = sum_k taps[k] x[n-k] (scipy.signal.lfilter(taps, [1], x))."""
    x = put(x)
    taps = put(taps)
    full = fftconvolve(x, taps, mode="full")
    return full[..., : x.shape[-1]]


@partial(jax.jit, static_argnames=("block", "n", "m", "real_out"))
def _overlap_save_jit(x, h_freq, block: int, n: int, m: int, real_out: bool):
    L = x.shape[-1]
    nblocks = -(-L // block)
    lead = x.shape[:-1]
    # Each block b filters x[b*block - (m-1) : b*block + n - (m-1)]; the
    # first m-1 outputs of each circular convolution are aliased and
    # discarded.  Frame with an (m-1)-sample left pad, batched.
    padded = jnp.pad(
        as_complex_array(x),
        [(0, 0)] * (x.ndim - 1) + [(m - 1, nblocks * block + n - m + 1 - L)],
    )
    idx = jnp.arange(nblocks)[:, None] * block + jnp.arange(n)[None, :]
    frames = jnp.take(padded, idx, axis=-1)  # (..., nblocks, n)
    filt = pow2_circular_filter(frames, h_freq, scale=1.0 / n)
    y = filt[..., m - 1 : m - 1 + block].reshape(*lead, nblocks * block)
    y = y[..., :L]
    return jnp.real(y) if real_out else y


def overlap_save(x, taps, block: int | None = None) -> jax.Array:
    """Long-signal causal FIR via overlap-save (zero initial state).

    Equivalent to fir_filter but processes the signal in power-of-2
    blocks with the tap spectrum computed once — ALL blocks run as one
    batched kernel-chain launch.  block: output samples per block
    (default: a kernel-friendly size >= 8 * len(taps)).
    """
    x = put(x)
    taps = put(taps)
    m = taps.shape[-1]
    if m == 0:
        raise ValueError("empty taps")
    if m > x.shape[-1]:
        return fir_filter(x, taps)
    if block is None:
        block = max(1024, next_power_of_2(8 * m))
        block = min(block, next_power_of_2(x.shape[-1]))
    if block < m:
        raise ValueError(
            f"block ({block}) must be >= len(taps) ({m}) for overlap-save"
        )
    n = next_power_of_2(block + m - 1)
    real_out = x.dtype.kind != "c" and taps.dtype.kind != "c"
    cdt = complex_for(jnp.promote_types(x.dtype, taps.dtype))
    h = fft(jnp.pad(as_complex_array(taps).astype(cdt), (0, n - m)))
    return _overlap_save_jit(x, h, int(block), n, m, real_out)


def convolve(in1, in2, mode: str = "full", method: str = "auto") -> jax.Array:
    """Generic convolution entry point (scipy.signal.convolve surface).
    All methods route to the kernel-chain FFT convolution, so 'direct'
    and 'auto' are accepted for API compatibility and produce identical
    (float) results."""
    if method not in ("auto", "fft", "direct"):
        raise ValueError("method must be 'auto', 'fft', or 'direct'")
    return fftconvolve(in1, in2, mode=mode)


def oaconvolve(in1, in2, mode: str = "full") -> jax.Array:
    """Overlap-add convolution (scipy.signal.oaconvolve surface).  For
    unbounded streams use models.overlap_save (the batched blockwise
    form); for in-memory signals the single kernel-chain launch of
    fftconvolve is one batched schedule, and the results are identical,
    so this routes there."""
    return fftconvolve(in1, in2, mode=mode)


def choose_conv_method(in1, in2, mode: str = "full", measure: bool = False):
    """Convolution-method advisor (scipy.signal.choose_conv_method
    surface).  Every method routes to the batched FFT chain here, so
    the answer is always 'fft'; with measure=True the actual
    fftconvolve time is reported."""
    if not measure:
        return "fft"
    import time

    t0 = time.perf_counter()
    fftconvolve(in1, in2, mode=mode).block_until_ready()
    return "fft", {"fft": time.perf_counter() - t0}


@partial(jax.jit, static_argnames=(
    "n_out", "start", "stop", "squared", "residual", "is_complex"))
def _envelope_jit(z, n_out: int, start: int, stop: int, squared: bool,
                  residual, is_complex: bool):
    """envelope's whole pipeline as ONE program (band select, baseband
    inverse, magnitude, residual rebuild)."""
    from godsp_tpu.fft.core import ifft as _ifft

    n = z.shape[-1]
    fak = n_out / n
    Z = fft(as_complex_array(z))
    if not is_complex:
        wgt = np.zeros(n)
        wgt[: n // 2 + 1] = 1.0
        if start > 0:
            wgt[start:stop] = 2.0
        elif stop > 0:
            wgt[1:stop] = 2.0
        Z = Z * jnp.asarray(wgt, Z.real.dtype)
    idx = np.arange(start, stop) % n
    band = Z[..., jnp.asarray(idx)]
    L = band.shape[-1]
    bpad = jnp.pad(band, [(0, 0)] * (band.ndim - 1) + [(0, n_out - L)])
    z_bb = _ifft(bpad) * fak
    z_env = (z_bb.real**2 + z_bb.imag**2) if squared else jnp.abs(z_bb)
    if residual is None:
        return z_env
    mask = np.ones(n)
    mask[idx] = 0.0
    if residual == "lowpass":
        if stop > 0:
            mask[stop : (n + 1) // 2] = 0.0
        else:
            mask[np.arange(start, (n + 1) // 2) % n] = 0.0
    Zr = Z * jnp.asarray(mask, Z.real.dtype)
    if is_complex:
        from godsp_tpu.models._resample_impl import _resample_jit

        z_res = _resample_jit(Zr, n_out, False, None, "freq")
    else:
        half = Zr[..., : n // 2 + 1]
        m = min(n, n_out)
        if n_out != n and m % 2 == 0:
            half = half.at[..., m // 2].multiply(2.0 if n_out < n else 0.5)
        nbins = n_out // 2 + 1
        if half.shape[-1] < nbins:
            half = jnp.pad(half,
                           [(0, 0)] * (half.ndim - 1)
                           + [(0, nbins - half.shape[-1])])
        else:
            half = half[..., :nbins]
        neg = jnp.conj(half[..., 1 : (n_out + 1) // 2][..., ::-1])
        full = jnp.concatenate([half, neg], axis=-1)
        z_res = jnp.real(_ifft(full)) * fak
    return jnp.stack([z_env, z_res], axis=0)


def envelope(z, bp_in: tuple = (1, None), *, n_out: int | None = None,
             squared: bool = False, residual: str | None = "lowpass",
             axis: int = -1):
    """Band-restricted analytic envelope + residual
    (scipy.signal.envelope semantics): select the FFT bins
    bp_in[0]:bp_in[1] (integer frequencies, negatives allowed), form
    the analytic/baseband signal of that band (resampled to n_out),
    return its magnitude (or squared magnitude) stacked with the
    residual of the out-of-band part ('lowpass' keeps only bins below
    the band, 'all' keeps everything outside, None skips it)."""
    z = put(z)
    if not jnp.issubdtype(z.dtype, jnp.inexact):
        from godsp_tpu._dtypes import default_float

        z = z.astype(default_float())
    if residual not in ("lowpass", "all", None):
        raise ValueError("residual must be 'lowpass', 'all', or None")
    z = jnp.moveaxis(z, axis, -1)
    n = z.shape[-1]
    n_out = n if n_out is None else int(n_out)
    if n_out < 1:
        raise ValueError("n_out must be positive")
    start = bp_in[0] if bp_in[0] is not None else -(n // 2)
    stop = bp_in[1] if bp_in[1] is not None else (n + 1) // 2
    if not -(n // 2) <= start < stop <= (n + 1) // 2:
        raise ValueError("need -n//2 <= bp_in[0] < bp_in[1] <= (n+1)//2")
    if stop - start > n_out:
        raise ValueError("n_out must be at least the bandwidth of bp_in")
    out = _envelope_jit(z, n_out, start, stop, bool(squared), residual,
                        z.dtype.kind == "c")
    if residual is None:
        return jnp.moveaxis(out, -1, axis)
    # the stacked (env, residual) output has a new leading axis, so a
    # non-negative target shifts by one
    return jnp.moveaxis(out, -1, axis + 1 if axis >= 0 else axis)
