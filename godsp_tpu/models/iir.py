"""IIR filtering as a blocked parallel scan (parallel linear recurrence).

The reference library has no IIR surface (go-dsp stops at FFT-domain
convolution, fft/fft.go:55-69); production DSP needs recursive filters.
A direct translation — the per-sample loop scipy.signal.lfilter runs in
C — is the worst possible accelerator program (a data-dependent chain of
scalar ops).  Instead the transposed-direct-form-II recurrence

    s[n] = A s[n-1] + g x[n]          (k = filter order states)
    y[n] = b0 x[n] + s[n-1][0]

is evaluated in two levels, both compiler-friendly:

  1. Within blocks of T samples, the state contribution of the block's
     own inputs is a CAUSAL MATMUL against the trace-time constant
     kernel K[m, j] = A^(m-j) g (lower-triangular, (T, T, k)) — matmul
     work at N*T*k mults, no sequential dependence.
  2. Across the N/T blocks, carries compose associatively:
     h[b+1] = A^T h[b] + part[b, T-1] — one jax.lax.associative_scan
     over (k x k) matrices, log2(N/T) levels of tiny matmuls.

All A-power tables are built in float64 numpy at trace time (the same
discipline as the FFT twiddle caches); nothing requests x64 on device.

API mirrors scipy.signal: lfilter (with zi/zf streaming state),
lfilter_zi, sosfilt, filtfilt ('pad' method, odd extension) — validated
against scipy float64 in tests/test_models.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu._dtypes import default_float

__all__ = [
    "filtfilt",
    "lfilter",
    "lfilter_zi",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
    "lfiltic",
]

_HI = jax.lax.Precision.HIGHEST


def _norm_ba(b, a):
    """float64 (b, a) padded to equal length, a[0] normalized to 1."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if b.ndim != 1 or a.ndim != 1:
        raise ValueError("b and a must be 1-D coefficient vectors")
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    n = max(len(b), len(a))
    b = np.pad(b, (0, n - len(b))) / a[0]
    a = np.pad(a, (0, n - len(a))) / a[0]
    return b, a


def _tdf2(b, a):
    """Transposed-direct-form-II state matrices (float64).

    A = companion(a).T (first column -a[1:], ones on the superdiagonal),
    g[i] = b[i+1] - a[i+1] * b[0], y[n] = b0 x[n] + s[n-1][0].
    """
    k = len(a) - 1
    A = np.zeros((k, k))
    A[:, 0] = -a[1:]
    A[: k - 1, 1:] = np.eye(k - 1)
    g = b[1:] - a[1:] * b[0]
    return A, g, b[0]


@lru_cache(maxsize=None)
def _block_tables(ba_key, T: int):
    """Trace-time float64 tables for one (b, a, T) geometry.

    Returns (K (T, T, k): causal input->state kernel, P (T, k, k): A^(m+1)
    carry propagators, AT (k, k) = A^T, g, b0)."""
    b, a = ba_key
    A, g, b0 = _tdf2(np.asarray(b), np.asarray(a))
    k = A.shape[0]
    V = np.empty((T, k))  # V[d] = A^d g
    Pw = np.empty((T + 1, k, k))  # Pw[d] = A^d
    Pw[0] = np.eye(k)
    V[0] = g
    for d in range(1, T + 1):
        Pw[d] = A @ Pw[d - 1]
        if d < T:
            V[d] = A @ V[d - 1]
    m = np.arange(T)
    d = m[:, None] - m[None, :]
    K = np.where((d >= 0)[..., None], V[d.clip(min=0)], 0.0)  # (T, T, k)
    P = Pw[1 : T + 1]  # A^(m+1), m = 0..T-1
    return K, P, Pw[T], g, b0


def _carry_scan(AT, pend, zi):
    """h[b] = state entering block b (h[0] = zi), via associative scan.

    pend: (B, r, k) = each block's own-input contribution at its last
    sample; carries compose as (M2, v2) o (M1, v1) = (M2 M1, M2 v1 + v2).
    """
    B = pend.shape[0]
    Ms = jnp.broadcast_to(AT, (B,) + AT.shape)

    def combine(lo, hi):
        M1, v1 = lo
        M2, v2 = hi
        return (
            jnp.einsum("...ij,...jk->...ik", M2, M1, precision=_HI),
            jnp.einsum("...ij,...rj->...ri", M2, v1, precision=_HI) + v2,
        )

    Mc, vc = jax.lax.associative_scan(combine, (Ms, pend))
    # exclusive: block b sees the composition of blocks 0..b-1 applied
    # to zi; block 0 sees zi itself.
    hz = jnp.einsum("bij,rj->bri", Mc[:-1], zi, precision=_HI) + vc[:-1]
    h0 = jnp.broadcast_to(zi, pend.shape[1:])[None]
    return jnp.concatenate([h0, hz], axis=0)  # (B, r, k)


@partial(jax.jit, static_argnames=("ba_key", "T", "N"))
def _lfilter_core(x2, zi2, ba_key, T: int, N: int):
    """x2: (r, N) padded to B*T; zi2: (r, k).  Returns (y (r, N), zf)."""
    fdt = x2.dtype
    K, P, AT, g, b0 = _block_tables(ba_key, T)
    K = jnp.asarray(K, fdt)
    P = jnp.asarray(P, fdt)
    AT = jnp.asarray(AT, fdt)
    r = x2.shape[0]
    B = x2.shape[1] // T
    X = x2.reshape(r, B, T)

    # 1. own-input state contributions (causal matmul):
    part = jnp.einsum("mjs,rbj->brms", K, X, precision=_HI)  # (B, r, T, k)

    # 2. cross-block carries (associative scan over B):
    h = _carry_scan(AT, part[:, :, T - 1, :], zi2)  # (B, r, k)

    # 3. full state: s[m] = A^(m+1) h + part[m]
    s = jnp.einsum("mik,brk->brmi", P, h, precision=_HI) + part

    # 4. y[n] = b0 x[n] + s[n-1][0]  (s[-1] of a block = its carry h)
    s1 = jnp.concatenate([h[:, :, None, 0], s[:, :, :-1, 0]], axis=2)
    y = jnp.asarray(b0, fdt) * X + jnp.moveaxis(s1, 0, 1)
    zf = s.reshape(B, r, T, -1).transpose(1, 0, 2, 3).reshape(
        r, B * T, -1
    )[:, N - 1, :]
    return y.reshape(r, B * T)[:, :N], zf


def _resolve_block(N: int, T: int | None) -> int:
    if T is None:
        T = 128
    return max(8, min(T, int(N)))


def lfilter(b, a, x, zi=None, axis: int = -1, block_size: int | None = None):
    """Apply the IIR/FIR filter (b, a) along `axis` of x.

    scipy.signal.lfilter semantics: returns y, or (y, zf) when an
    initial state zi (shape (..., max(len(a), len(b)) - 1), transposed
    direct-form II) is given — feeding zf of one chunk as zi of the
    next streams a long signal in blocks with exact continuity.
    block_size tunes the internal matmul tile (default 128 lanes).
    """
    bn, an = _norm_ba(b, a)
    ba_key = (tuple(bn.tolist()), tuple(an.tolist()))
    k = len(an) - 1
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            yr = lfilter(bn, an, x.real, None if zi is None else jnp.real(zi),
                         axis, block_size)
            yi = lfilter(bn, an, x.imag, None if zi is None else jnp.imag(zi),
                         axis, block_size)
            if zi is None:
                return jax.lax.complex(yr, yi)
            return (jax.lax.complex(yr[0], yi[0]),
                    jax.lax.complex(yr[1], yi[1]))
        x = x.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    lead, N = x.shape[:-1], x.shape[-1]
    if N == 0:
        raise ValueError("x must have at least one sample along axis")
    if k == 0:
        # Pure gain (len(b) == len(a) == 1): no state.
        y = jnp.moveaxis(jnp.asarray(bn[0], x.dtype) * x, -1, axis)
        if zi is None:
            return y
        return y, jnp.zeros(lead + (0,), x.dtype)

    r = int(np.prod(lead, dtype=np.int64)) if lead else 1
    x2 = x.reshape(r, N)
    want_zf = zi is not None
    if zi is None:
        zi2 = jnp.zeros((r, k), x.dtype)
    else:
        zi2 = jnp.broadcast_to(jnp.asarray(zi, x.dtype), lead + (k,))
        zi2 = zi2.reshape(r, k)
    T = _resolve_block(N, block_size)
    pad = (-N) % T
    if pad:
        x2 = jnp.pad(x2, ((0, 0), (0, pad)))
    y2, zf2 = _lfilter_core(x2, zi2, ba_key, T, N)
    y = jnp.moveaxis(y2.reshape(lead + (N,)), -1, axis)
    if not want_zf:
        return y
    return y, zf2.reshape(lead + (k,))


def lfilter_zi(b, a):
    """Steady-state TDF-II initial conditions for a unit step input
    (scipy.signal.lfilter_zi): lfilter(b, a, ones, zi=zi * x[0]) starts
    with no transient.  Solved in float64 at trace time."""
    bn, an = _norm_ba(b, a)
    A, g, b0 = _tdf2(bn, an)
    k = A.shape[0]
    if k == 0:
        return jnp.zeros((0,), default_float())
    # steady state: s = A s + g  =>  (I - A) s = g; y offset handled by
    # the b0 feed-through exactly as scipy does.
    zi = np.linalg.solve(np.eye(k) - A, g)
    return jnp.asarray(zi, default_float())


def sosfilt(sos, x, zi=None, axis: int = -1, block_size: int | None = None):
    """Cascade of second-order sections (scipy.signal.sosfilt).

    sos: (n_sections, 6); zi: (n_sections, ..., 2).  Returns y, or
    (y, zf) when zi is given."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    y = x
    zfs = []
    for i, sec in enumerate(sos):
        zi_i = None if zi is None else zi[i]
        out = lfilter(sec[:3], sec[3:], y, zi_i, axis, block_size)
        if zi is None:
            y = out
        else:
            y, zf = out
            zfs.append(zf)
    if zi is None:
        return y
    return y, jnp.stack(zfs, axis=0)


def sosfilt_zi(sos):
    """Steady-state initial conditions for sosfilt under a unit step
    (scipy.signal.sosfilt_zi): per-section lfilter_zi scaled by the
    cumulative DC gain of the preceding sections.  Shape
    (n_sections, 2), float64 at trace time."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    zi = np.empty((sos.shape[0], 2))
    scale = 1.0
    for i, sec in enumerate(sos):
        b, a = _norm_ba(sec[:3], sec[3:])
        zi[i] = scale * np.asarray(lfilter_zi(b, a), np.float64)
        scale *= b.sum() / a.sum()
    return jnp.asarray(zi, default_float())


def sosfiltfilt(sos, x, axis: int = -1, padlen: int | None = None,
                block_size: int | None = None):
    """Zero-phase forward-backward SOS filtering (scipy.signal.sosfiltfilt,
    padtype='odd')."""
    sos = np.asarray(sos, np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError("sos must have shape (n_sections, 6)")
    n_sections = sos.shape[0]
    if padlen is None:
        # scipy's default: 3 * (2*n_sections + 1 - min(trailing zero
        # counts of the b and a sides))
        ntaps = 2 * n_sections + 1
        ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
        edge = int(3 * ntaps)
    else:
        edge = int(padlen)
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    N = x.shape[-1]
    if edge >= N:
        raise ValueError(
            f"padlen ({edge}) must be less than the signal length ({N})"
        )
    if edge > 0:
        head = 2.0 * x[..., :1] - x[..., edge:0:-1]
        tail = 2.0 * x[..., -1:] - x[..., -2 : -edge - 2 : -1]
        ext = jnp.concatenate([head, x, tail], axis=-1)
    else:
        ext = x
    zi = sosfilt_zi(sos).astype(ext.dtype)  # (S, 2)
    zi_shaped = zi.reshape((n_sections,) + (1,) * (ext.ndim - 1) + (2,))
    y, _ = sosfilt(sos, ext, zi=zi_shaped * ext[None, ..., :1],
                   block_size=block_size)
    y = y[..., ::-1]
    y, _ = sosfilt(sos, y, zi=zi_shaped * y[None, ..., :1],
                   block_size=block_size)
    y = y[..., ::-1]
    if edge > 0:
        y = y[..., edge:-edge]
    return jnp.moveaxis(y, -1, axis)


def filtfilt(b, a, x, axis: int = -1, padlen: int | None = None,
             block_size: int | None = None):
    """Zero-phase forward-backward filtering (scipy.signal.filtfilt,
    method='pad', padtype='odd')."""
    bn, an = _norm_ba(b, a)
    ntaps = len(bn)
    edge = 3 * ntaps if padlen is None else int(padlen)
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.inexact):
        x = x.astype(default_float())
    x = jnp.moveaxis(x, axis, -1)
    N = x.shape[-1]
    if edge >= N:
        raise ValueError(
            f"padlen ({edge}) must be less than the signal length ({N})"
        )
    if edge > 0:
        # odd extension: 2*x[0] - x[edge..1], x, 2*x[-1] - x[-2..-edge-1]
        head = 2.0 * x[..., :1] - x[..., edge:0:-1]
        tail = 2.0 * x[..., -1:] - x[..., -2 : -edge - 2 : -1]
        ext = jnp.concatenate([head, x, tail], axis=-1)
    else:
        ext = x
    zi = lfilter_zi(bn, an).astype(ext.dtype)
    y, _ = lfilter(bn, an, ext, zi=zi * ext[..., :1], block_size=block_size)
    y = y[..., ::-1]
    y, _ = lfilter(bn, an, y, zi=zi * y[..., :1], block_size=block_size)
    y = y[..., ::-1]
    if edge > 0:
        y = y[..., edge:-edge]
    return jnp.moveaxis(y, -1, axis)


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial conditions zi for lfilter given past outputs y (newest
    first) and optional past inputs x (scipy.signal.lfiltic): the
    direct-II-transposed state
    zi[m] = sum_i b[i+m+1] x[i] - sum_i a[i+m+1] y[i]."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    Nn = len(a) - 1
    Mm = len(b) - 1
    K = max(Mm, Nn)
    y = np.atleast_1d(np.asarray(y, np.float64))[:Nn]
    x = (np.zeros(0) if x is None
         else np.atleast_1d(np.asarray(x, np.float64)))[:Mm]
    zi = np.zeros(K)
    for m in range(K):
        for i, xi in enumerate(x):
            if m + 1 + i <= Mm:
                zi[m] += b[m + 1 + i] * xi
        for i, yi in enumerate(y):
            if m + 1 + i <= Nn:
                zi[m] -= a[m + 1 + i] * yi
    return zi
