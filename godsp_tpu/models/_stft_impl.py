"""Short-time Fourier transform, inverse, and spectrogram.

End-to-end pipelines built on the framework's batched FFT stack — the
"model family" layer above the raw transforms.  The reference library
stops at Welch PSD (spectral/pwelch.go); STFT/ISTFT/spectrogram use the
same framing/window/FFT machinery (spectral.Segment's geometry,
spectral.go:26-33, and window/window.go tapers) but keep per-frame
spectra instead of averaging them, which is what production audio/sensor
pipelines consume.

All functions are batched over leading axes and jit-compatible; every
power-of-2 transform goes through the one FFT dispatch (fft/pow2.py).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from godsp_tpu import window as win
from godsp_tpu._dtypes import as_real_array, default_float, put
from godsp_tpu.dsputils.utils import zero_pad
from godsp_tpu.fft.core import fft, fft_real, ifft

__all__ = [
    "StreamingISTFT",
    "StreamingSTFT",
    "check_cola",
    "check_nola",
    "istft",
    "spectrogram",
    "stft",
    "stft_frames",
    "stream_istft",
    "stream_stft",
    "check_COLA",
    "check_NOLA",
]

WindowSpec = Union[str, Callable[[int], jax.Array], None]


def _overlap_bin_sums(w: np.ndarray, step: int) -> np.ndarray:
    """sum_k w[i + k*step] over one step period (float64 host math)."""
    nper = w.shape[0]
    sums = np.zeros(step)
    for start in range(0, nper, step):
        seg = w[start : start + step]
        sums[: seg.shape[0]] += seg
    return sums


def check_cola(window: WindowSpec, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Whether (window, hop) satisfies the Constant-OverLap-Add
    constraint (scipy.signal.check_COLA): shifted copies of the window
    sum to a constant, so an unwindowed inverse STFT is exact."""
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError("need nperseg >= 1 and 0 <= noverlap < nperseg")
    w = win.window_table_np(window if window is not None else win.hann, nperseg)
    sums = _overlap_bin_sums(w, nperseg - noverlap)
    return bool(np.max(np.abs(sums - np.median(sums))) < tol)


def check_nola(window: WindowSpec, nperseg: int, noverlap: int,
               tol: float = 1e-10) -> bool:
    """Whether (window, hop) satisfies the NOnzero-OverLap-Add
    constraint (scipy.signal.check_NOLA): shifted squared windows sum
    strictly above tol everywhere, so the windowed-normalized istft
    (models.istft) inverts the stft."""
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError("need nperseg >= 1 and 0 <= noverlap < nperseg")
    w = win.window_table_np(window if window is not None else win.hann, nperseg)
    sums = _overlap_bin_sums(w * w, nperseg - noverlap)
    return bool(np.min(sums) > tol)


def _resolve_window(window: WindowSpec, nfft: int, dtype) -> jax.Array:
    wf = window if window is not None else win.hann
    return win.window_table(wf, nfft).astype(dtype)


def stft_frames(x: jax.Array, nfft: int, hop: int) -> jax.Array:
    """Frame a signal into overlapping segments (..., frames, nfft).

    Same geometry as spectral.Segment (spectral.go:26-33): frame count is
    (L - nfft)//hop + 1; trailing remainder samples are dropped.
    """
    if hop <= 0:
        raise ValueError("hop must be positive")
    L = x.shape[-1]
    if L < nfft:
        raise ValueError(f"signal length {L} < nfft {nfft}")
    n_frames = (L - nfft) // hop + 1
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(nfft)[None, :]
    return jnp.take(x, idx, axis=-1)


@partial(jax.jit, static_argnames=("nfft", "hop", "pad", "onesided"))
def _stft_jit(x, w, nfft: int, hop: int, pad: int, onesided: bool):
    frames = stft_frames(x, nfft, hop) * w
    if pad > nfft:
        frames = zero_pad(frames, pad)
    spec = fft_real(frames)
    if onesided:
        spec = spec[..., : pad // 2 + 1]
    return spec


def stft(
    x,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    onesided: bool = True,
) -> jax.Array:
    """Short-time Fourier transform of a real signal.

    x: (..., L) real.  Returns (..., n_frames, bins) complex with
    n_frames = (L - nfft)//hop + 1 and bins = pad//2 + 1 (one-sided) or
    pad.  Defaults: hop = nfft//2, window = Hann, pad = nfft — matching
    Pwelch's conventions (pwelch.go:85-95) so stft |.|^2 averages
    reproduce pwelch exactly.
    """
    x = as_real_array(x)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    pad = pad or nfft
    if pad < nfft:
        raise ValueError("pad must be >= nfft")
    w = _resolve_window(window, nfft, x.dtype)
    return _stft_jit(x, w, nfft, hop, pad, onesided)


def _mirror_full_spectrum(spec, pad: int):
    """One-sided (..., F, pad//2+1) complex -> full conjugate-symmetric
    pad-bin spectrum; odd pad has no real Nyquist bin (scipy irfft(n))."""
    mirrored = spec[..., 1:-1] if pad % 2 == 0 else spec[..., 1:]
    tail = jnp.conj(jnp.flip(mirrored, axis=-1))
    return jnp.concatenate([spec, tail], axis=-1)


def _nola_norm(w, n_frames: int, hop: int, length: int, fdt):
    """Least-squares denominator sum_f w^2[t - f*hop], length samples."""
    nfft = w.shape[0]
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(nfft)[None, :]
    norm = jnp.zeros(length, dtype=fdt).at[idx].add(
        jnp.broadcast_to(w * w, (n_frames, nfft))
    )
    return jnp.maximum(norm, jnp.finfo(fdt).tiny)


def _ola_unnorm(spec, w, nfft: int, hop: int, pad: int, onesided: bool):
    """Un-normalized windowed overlap-add over the covered span."""
    fdt = default_float()
    if onesided:
        spec = _mirror_full_spectrum(spec, pad)
    frames = jnp.real(ifft(spec))[..., :nfft].astype(fdt) * w
    n_frames = frames.shape[-2]
    span = (n_frames - 1) * hop + nfft
    idx = jnp.arange(n_frames)[:, None] * hop + jnp.arange(nfft)[None, :]
    flat = jnp.zeros(spec.shape[:-2] + (span,), dtype=fdt)
    return flat.at[..., idx].add(frames)


@partial(
    jax.jit,
    static_argnames=("nfft", "hop", "length", "onesided", "pad"),
)
def _istft_jit(spec, w, nfft: int, hop: int, length: int, onesided: bool,
               pad: int):
    # Weighted overlap-add with least-squares (NOLA) normalization:
    # y[t] = sum_f w*frames_f[t - f*hop] / sum_f w^2[t - f*hop].
    fdt = default_float()
    y = _ola_unnorm(spec, w, nfft, hop, pad, onesided)
    n_frames = spec.shape[-2]
    span = (n_frames - 1) * hop + nfft
    if length > span:
        y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, length - span)])
    else:
        y = y[..., :length]
    return y / _nola_norm(w, n_frames, hop, length, fdt)


def istft(
    spec,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    length: Optional[int] = None,
    onesided: bool = True,
    pad: Optional[int] = None,
) -> jax.Array:
    """Inverse STFT by weighted overlap-add (least-squares synthesis).

    spec: (..., n_frames, bins) complex from stft() with the same nfft,
    hop, and window.  Reconstructs the signal over the covered span
    (length defaults to (n_frames-1)*hop + nfft); exact wherever the
    window overlap satisfies NOLA (non-zero overlapped sum), e.g. Hann
    with hop <= nfft/2 — or any window at hop <= nfft/2 with the
    normalization used here.

    pad disambiguates the one-sided FFT length (as scipy's irfft takes
    n): bins = pad//2 + 1 holds for both pad = 2*(bins-1) and the odd
    pad = 2*bins - 1.  Defaults to the even choice; pass the stft call's
    pad explicitly when it was odd.
    """
    spec = put(spec)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    bins = spec.shape[-1]
    if onesided:
        pad = pad if pad is not None else 2 * (bins - 1)
        if pad // 2 + 1 != bins:
            raise ValueError(
                f"pad={pad} inconsistent with {bins} one-sided bins "
                f"(need pad//2 + 1 == bins)"
            )
    else:
        if pad is not None and pad != bins:
            raise ValueError(f"pad={pad} != two-sided bin count {bins}")
        pad = bins
    n_frames = spec.shape[-2]
    length = length or (n_frames - 1) * hop + nfft
    w = _resolve_window(window, nfft, default_float())
    return _istft_jit(spec, w, nfft, hop, length, onesided, pad)


def spectrogram(
    x,
    nfft: int,
    hop: Optional[int] = None,
    window: WindowSpec = None,
    pad: Optional[int] = None,
    scale: str = "power",
) -> jax.Array:
    """Magnitude spectrogram (..., n_frames, pad//2+1).

    scale: "power" -> |X|^2, "magnitude" -> |X|, "db" -> 10 log10(|X|^2)
    floored at -200 dB.
    """
    if scale not in ("power", "magnitude", "db"):
        raise ValueError(f"unknown scale: {scale}")
    x = as_real_array(x)
    hop = nfft // 2 if hop is None else hop
    if hop <= 0:
        raise ValueError("hop must be positive")
    spec = stft(x, nfft, hop, window, pad, onesided=True)
    p = spec.real * spec.real + spec.imag * spec.imag
    if scale == "magnitude":
        return jnp.sqrt(p)
    if scale == "db":
        return 10.0 * jnp.log10(jnp.maximum(p, 1e-20))
    return p


def _settle_ola_block(own, spill_in, gate, w, nfft: int, hop: int, F: int):
    """NOLA-normalize a block of F frames' un-normalized OLA whose head
    may receive a predecessor's spill.

    own: (..., F*hop) un-normalized OLA of the block's own frames;
    spill_in: (..., nfft-hop) the predecessor's overlap spill (ignored
    when nfft == hop); gate: traced 0/1 — 0 when no predecessor frames
    exist, masking BOTH the spill and its norm-tail contribution so
    boundary normalization is exactly the unsharded pattern.  The norm
    tail is block-size-invariant given F*hop >= nfft-hop (the caller's
    validation), which is what lets streaming chunks and mesh shards
    share this arithmetic (parallel/stft_sharded.py).
    """
    fdt = default_float()
    H = nfft - hop
    own_len = F * hop
    norm_loc = _nola_norm(w, F, hop, (F - 1) * hop + nfft, fdt)
    norm = norm_loc[:own_len]
    if H > 0:
        own = own.at[..., :H].add(gate * spill_in)
        norm = norm.at[:H].add(gate * norm_loc[own_len:])
    return own / jnp.maximum(norm, jnp.finfo(fdt).tiny)


@partial(jax.jit, static_argnames=("nfft", "hop", "pad", "onesided"))
def _istft_chunk_jit(spec, carry, gate, w, nfft: int, hop: int, pad: int,
                     onesided: bool):
    """ONE device program per spectra chunk (streaming synthesis).

    Un-normalized OLA of the chunk's frames, inject the carried
    (nfft - hop)-sample spill from the previous chunk, NOLA-normalize
    the owned F*hop block, and emit the new spill.  gate is a traced
    0/1 scalar (0 on the first chunk, whose head has no predecessor
    frames) so chunk count never forces a recompile — same discipline
    as parallel.streaming._chunk_accumulate.
    """
    y = _ola_unnorm(spec, w, nfft, hop, pad, onesided)
    F = spec.shape[-2]
    own_len = F * hop
    out = _settle_ola_block(y[..., :own_len], carry, gate, w, nfft, hop, F)
    return out, y[..., own_len:]


@partial(jax.jit, static_argnames=("F", "hop"))
def _coda_finalize(carry, w, F: int, hop: int):
    """Normalize the final spill: only the last chunk's frames cover it."""
    fdt = default_float()
    nfft = w.shape[0]
    norm = _nola_norm(w, F, hop, (F - 1) * hop + nfft, fdt)[F * hop :]
    return carry / jnp.maximum(norm, jnp.finfo(fdt).tiny)


class StreamingISTFT:
    """Chunked inverse STFT: synthesis twin of parallel.stream_pwelch.

    Push spectra chunks (..., F_k, bins) in frame order; each push runs
    one device program and returns the (..., F_k*hop) time block it
    fully determines.  flush() returns the final (nfft - hop)-sample
    coda.  The concatenation of all pushed blocks plus the coda equals
    models.istft of the concatenated spectra, exactly — the overlap
    spill crossing each chunk boundary is carried on-device, never
    re-normalized twice.  Every chunk needs F_k*hop >= nfft - hop so a
    spill reaches only its immediate successor.

    The reference has no synthesis streaming (its streaming surface is
    wav.ReadSamples, wav/wav.go:113-134); this mirrors that contract on
    the synthesis side for hours-long outputs that never fit in HBM.
    """

    def __init__(
        self,
        nfft: int,
        hop: Optional[int] = None,
        window: WindowSpec = None,
        pad: Optional[int] = None,
        onesided: bool = True,
    ):
        self.nfft = nfft
        self.hop = nfft // 2 if hop is None else hop
        if self.hop <= 0:
            raise ValueError("hop must be positive")
        if self.hop > nfft:
            raise ValueError("streaming synthesis requires hop <= nfft")
        self.pad = pad or nfft
        if self.pad < nfft:
            raise ValueError("pad must be >= nfft")
        self.onesided = onesided
        self.w = _resolve_window(window, nfft, default_float())
        self._carry = None
        self._first = True
        self._last_frames = 0
        self._flushed = False

    def push(self, spec) -> jax.Array:
        """Consume one spectra chunk, return its settled time block."""
        if self._flushed:
            raise RuntimeError("push() after flush()")
        spec = put(spec)
        bins = self.pad // 2 + 1 if self.onesided else self.pad
        if spec.ndim < 2 or spec.shape[-1] != bins:
            raise ValueError(
                f"chunk must be (..., F, {bins}), got {spec.shape}"
            )
        F = spec.shape[-2]
        H = self.nfft - self.hop
        if F * self.hop < H:
            raise ValueError(
                f"chunk too short: F*hop = {F * self.hop} < nfft-hop = {H}"
            )
        if self._carry is None:
            fdt = default_float()
            self._carry = jnp.zeros(spec.shape[:-2] + (H,), fdt)
        gate = jnp.asarray(0.0 if self._first else 1.0, default_float())
        out, self._carry = _istft_chunk_jit(
            spec, self._carry, gate, self.w, self.nfft, self.hop, self.pad,
            self.onesided,
        )
        self._first = False
        self._last_frames = F
        return out

    def flush(self) -> jax.Array:
        """Return the final coda (the spill past the last owned block)."""
        if self._flushed:
            raise RuntimeError("flush() called twice")
        self._flushed = True
        if self._carry is None or self.nfft == self.hop:
            return jnp.zeros(
                (0,) if self._carry is None else self._carry.shape,
                default_float(),
            )
        return _coda_finalize(self._carry, self.w, self._last_frames, self.hop)


def stream_istft(chunks, nfft: int, hop: Optional[int] = None,
                 window: WindowSpec = None, pad: Optional[int] = None,
                 onesided: bool = True):
    """Generator over StreamingISTFT: yields each chunk's time block,
    then the final coda.  np.concatenate(list(...)) == models.istft of
    the concatenated spectra."""
    s = StreamingISTFT(nfft, hop, window, pad, onesided)
    for spec in chunks:
        yield s.push(spec)
    yield s.flush()


class _StreamingFramer:
    """Host-side frame-boundary bookkeeping for chunked analysis.

    Accumulates sample blocks (..., L_k) and hands back the longest
    prefix covering whole frames (frame count (L - nfft)//hop + 1, the
    spectral.Segment geometry, spectral.go:26-33); the tail past the
    last consumed frame start (< nfft samples) is carried into the next
    block on the host — the block itself then makes ONE device trip.
    """

    def __init__(self, nfft: int, hop: int):
        self.nfft, self.hop = nfft, hop
        self._carry = None

    def push(self, block):
        block = np.asarray(block)
        buf = (
            block
            if self._carry is None
            else np.concatenate([self._carry, block], axis=-1)
        )
        if buf.shape[-1] < self.nfft:
            self._carry = buf
            return None
        k = (buf.shape[-1] - self.nfft) // self.hop + 1
        self._carry = buf[..., k * self.hop :]
        return buf[..., : (k - 1) * self.hop + self.nfft]

    @property
    def leftover(self) -> int:
        """Samples carried (or buffered pre-first-frame) right now."""
        return 0 if self._carry is None else self._carry.shape[-1]


class StreamingSTFT:
    """Chunked forward STFT: the analysis twin of StreamingISTFT.

    Push sample blocks (..., L_k) in time order; each push returns the
    (..., F_k, bins) spectra block it fully determines (or None while
    fewer than nfft samples have arrived).  The concatenation of all
    returned blocks equals models.stft of the concatenated signal,
    exactly — per-frame kernel math is batch-independent, and the
    (< nfft)-sample tail behind the last frame start is carried on the
    host into the next block.  Like the one-shot stft (and
    spectral.Segment, spectral.go:36-44), the final remainder that
    never fills a frame is dropped.

    Each push runs one device program; block lengths that are a
    multiple of hop keep the carry length constant so every chunk after
    the first reuses one compiled program (the same discipline as
    parallel.streaming).
    """

    def __init__(
        self,
        nfft: int,
        hop: Optional[int] = None,
        window: WindowSpec = None,
        pad: Optional[int] = None,
        onesided: bool = True,
    ):
        self.nfft = nfft
        self.hop = nfft // 2 if hop is None else hop
        if self.hop <= 0:
            raise ValueError("hop must be positive")
        self.pad = pad or nfft
        if self.pad < nfft:
            raise ValueError("pad must be >= nfft")
        self.window = window
        self.onesided = onesided
        self._framer = _StreamingFramer(nfft, self.hop)

    def update(self, block) -> Optional[jax.Array]:
        """Consume one sample block; return its spectra block (or None)."""
        seg = self._framer.push(block)
        if seg is None:
            return None
        return stft(
            seg, self.nfft, self.hop, self.window, self.pad, self.onesided
        )

    @property
    def leftover(self) -> int:
        """Samples buffered toward the next frame."""
        return self._framer.leftover


def stream_stft(chunks, nfft: int, hop: Optional[int] = None,
                window: WindowSpec = None, pad: Optional[int] = None,
                onesided: bool = True):
    """Generator over StreamingSTFT: yields one spectra block per input
    block once frames are available.  np.concatenate(list(...), axis=-2)
    == models.stft of the concatenated signal."""
    s = StreamingSTFT(nfft, hop, window, pad, onesided)
    for block in chunks:
        spec = s.update(block)
        if spec is not None:
            yield spec


# scipy.signal's exported capitalizations
check_COLA = check_cola
check_NOLA = check_nola
