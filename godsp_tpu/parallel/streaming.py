"""Streaming distributed Welch PSD with checkpoint/resume.

The production driver for hours-long recordings (SURVEY.md §5): time
blocks stream from the host (e.g. wav.Wav.blocks), each chunk is
processed by the sharded partial step (halo exchange + psum), and the
running (periodogram sum, segment count) reduction state is periodically
snapshotted so a restart resumes at the last completed chunk — everything
else is recomputable.  Failure policy is fail-fast per JAX multi-host
convention; no elastic resize.

Exactness: chunk boundaries pass the head of the next chunk as the tail
halo, so the union of per-chunk segments is exactly the reference's
global segmentation ((L-nfft)/stride+1, spectral.go:26-33) — no segment
is dropped or double-counted.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from godsp_tpu import window as win
from godsp_tpu._dtypes import default_float
from godsp_tpu.parallel._pwelch_sharded_impl import (
    resolve_geometry,
    sharded_partial_step,
)
from godsp_tpu.spectral._pwelch_impl import PwelchOptions

__all__ = ["StreamingPwelch", "stream_pwelch",
    "stream_welch",
]


@jax.jit
def _neumaier_add(s, c, x):
    """Compensated (Neumaier) accumulation: returns (s', c') with
    s' + c' ~= s + c + x at ~double the working precision."""
    t = s + x
    c = c + jnp.where(jnp.abs(s) >= jnp.abs(x), (s - t) + x, (x - t) + s)
    return t, c


from functools import partial as _partial


@_partial(
    jax.jit,
    static_argnames=(
        "mesh", "nfft", "pad", "stride", "segs_per_shard", "lp",
        "channels", "chunk_len",
    ),
)
def _chunk_accumulate(
    ext, w_pad, acc_s, acc_c, total_segs,
    mesh, nfft, pad, stride, segs_per_shard, lp, channels, chunk_len,
):
    """ONE device program per chunk: slice off the tail halo, sharded
    partial step, reshape, compensated accumulate.  The chunk and its
    halo arrive as ONE host buffer, so each chunk costs one transfer and
    one dispatch.
    """
    x = ext[..., :chunk_len]
    tail = ext[..., chunk_len:]
    p, _count = sharded_partial_step(
        x, tail, w_pad, mesh, nfft, pad, stride, segs_per_shard, lp,
        total_segs,
    )
    p = p.reshape(channels, lp)
    return _neumaier_add(acc_s, acc_c, p)

log = logging.getLogger("godsp_tpu.streaming")


@dataclass
class StreamingMetrics:
    """Per-run observability (the reference has none — SURVEY.md §5)."""

    samples_in: int = 0
    segments_done: int = 0
    chunks_done: int = 0
    wall_s: float = 0.0

    @property
    def samples_per_s(self) -> float:
        return self.samples_in / self.wall_s if self.wall_s else 0.0

    def json_line(self) -> str:
        return json.dumps(
            dict(
                samples_in=self.samples_in,
                segments=self.segments_done,
                chunks=self.chunks_done,
                wall_s=self.wall_s,
                msamples_per_s=self.samples_per_s / 1e6,
            )
        )


class StreamingPwelch:
    """Accumulates a Welch PSD over a sample stream, sharded over a mesh.

    Usage:
        sp = StreamingPwelch(fs, options, mesh, segs_per_chunk_shard=512)
        for block in wav.blocks(1 << 20):
            sp.update(block)
        pxx, freqs = sp.finalize()

    update() buffers on the host and launches one device step per full
    chunk (chunk = n_sp * segs_per_chunk_shard * stride samples, plus the
    noverlap-sample halo that update() peeks from the following data).

    channels > 1 streams multiple aligned channels: update() takes
    (channels, n) blocks, finalize() returns (channels, lp) Pxx, and the
    channel axis shards over the mesh's "dp" axis (the time axis still
    shards over "sp").
    """

    def __init__(
        self,
        fs: float,
        options: Optional[PwelchOptions] = None,
        mesh: Optional[Mesh] = None,
        segs_per_chunk_shard: int = 256,
        checkpoint_path: Optional[str] = None,
        checkpoint_every_chunks: int = 0,
        channels: int = 1,
    ):
        from godsp_tpu.parallel.mesh import make_mesh

        self.fs = float(fs)
        self.options = options or PwelchOptions()
        self.mesh = mesh if mesh is not None else make_mesh()
        (
            self.nfft,
            self._wf,
            self.pad,
            self.fft_len,
            self.noverlap,
            self._scaling,
            self.stride,
            self.lp,
        ) = resolve_geometry(self.options)
        self.n_sp = self.mesh.shape["sp"]
        self.channels = int(channels)
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        n_dp = self.mesh.shape.get("dp", 1)
        if n_dp > 1 and self.channels % n_dp != 0:
            raise ValueError(
                f"channels ({self.channels}) must divide over the dp axis ({n_dp})"
            )
        self.segs_per_shard = int(segs_per_chunk_shard)
        self.chunk_len = self.n_sp * self.segs_per_shard * self.stride
        self.halo = max(self.nfft - self.stride, 0)
        if self.halo > self.segs_per_shard * self.stride:
            raise ValueError(
                f"per-shard block ({self.segs_per_shard * self.stride}) must hold "
                f"the {self.halo}-sample overlap halo; raise segs_per_chunk_shard"
            )

        fdt = default_float()
        self._w_pad = win.window_table(self._wf, self.fft_len).astype(fdt)
        w_nfft = win.window_table_np(self._wf, self.nfft)
        self._w_norm = float(np.sum(w_nfft * w_nfft)) * (self.fs if self._scaling else 1.0)

        from godsp_tpu._dtypes import np_float
        from godsp_tpu.native import StreamBuffer

        # Chunk assembly in the native growable FIFO (numpy fallback):
        # amortized O(1) push/consume vs re-concatenating the tail.
        # Buffered at the policy dtype — f32 on the accelerator halves host
        # memcpy and host->device transfer; f64 under x64 (CPU parity runs).
        self._np_float = np_float()
        self._bufs = [
            StreamBuffer(
                capacity=2 * (self.chunk_len + self.halo), dtype=self._np_float
            )
            for _ in range(self.channels)
        ]
        self._buf = self._bufs[0]  # single-channel accessor (tests, repr)
        # Device-resident Neumaier-compensated periodogram accumulator:
        # per-chunk results are added ON DEVICE (no per-chunk readback,
        # so host->device transfers pipeline with compute); the
        # compensation term gives ~double-precision accuracy at f32.
        self._acc_s = None  # (C, lp) running sum
        self._acc_c = None  # (C, lp) compensation
        self._count = 0.0
        self._consumed = 0  # global samples fully folded into the state
        self._t_first: Optional[float] = None  # wall clock of first update
        self.metrics = StreamingMetrics()

        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every_chunks)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self._restore(checkpoint_path)

    def _acc_read(self) -> np.ndarray:
        """Materialize the accumulator as float64 (blocking readback)."""
        if self._acc_s is None:
            return np.zeros((self.channels, self.lp), dtype=np.float64)
        return np.asarray(self._acc_s, dtype=np.float64) + np.asarray(
            self._acc_c, dtype=np.float64
        )

    # -- checkpoint / resume (SURVEY.md §5) -----------------------------
    def _snapshot(self) -> None:
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                p_sum=self._acc_read(),
                count=self._count,
                consumed=self._consumed,
                buf=np.stack([b.peek(len(b)) for b in self._bufs]),
                chunks=self.metrics.chunks_done,
                segments=self.metrics.segments_done,
                samples_in=self.metrics.samples_in,
            )
        os.replace(tmp, self.checkpoint_path)
        log.info("checkpoint @ chunk %d -> %s", self.metrics.chunks_done, self.checkpoint_path)

    def _restore(self, path: str) -> None:
        from godsp_tpu._dtypes import default_float

        z = np.load(path)
        p_sum = z["p_sum"]
        if p_sum.ndim == 1:  # pre-multichannel snapshot
            p_sum = p_sum[None, :]
        fdt = default_float()
        s = p_sum.astype(fdt)
        self._acc_s = jnp.asarray(s)
        self._acc_c = jnp.asarray((p_sum - s.astype(np.float64)).astype(fdt))
        self._count = float(z["count"])
        self._consumed = int(z["consumed"])
        buf = z["buf"]
        if buf.ndim == 1:
            buf = buf[None, :]
        for b, row in zip(self._bufs, buf):
            b.consume(len(b))
            b.push(row)
        self.metrics.chunks_done = int(z["chunks"])
        self.metrics.segments_done = int(z["segments"])
        self.metrics.samples_in = int(z["samples_in"])
        log.info("resumed from %s at chunk %d", path, self.metrics.chunks_done)

    # -- streaming ------------------------------------------------------
    def update(self, samples: np.ndarray) -> None:
        """Fold a new block of samples into the running PSD.

        samples: (n,) for single-channel, (channels, n) otherwise.
        """
        if self._t_first is None:
            self._t_first = time.perf_counter()
        samples = np.asarray(samples, dtype=self._np_float)
        if self.channels == 1:
            samples = samples.reshape(1, -1)
        elif samples.ndim != 2 or samples.shape[0] != self.channels:
            raise ValueError(
                f"expected ({self.channels}, n) samples, got {samples.shape}"
            )
        for b, row in zip(self._bufs, samples):
            b.push(row)
        self.metrics.samples_in += samples.shape[-1]
        # A chunk is processable once its tail halo is also buffered.
        while len(self._bufs[0]) >= self.chunk_len + self.halo:
            peeks = [b.peek(self.chunk_len + self.halo) for b in self._bufs]
            # Single-channel: hand the peek copy through without restacking.
            ext = peeks[0][None] if self.channels == 1 else np.stack(peeks)
            self._process(ext, total_segs=self.n_sp * self.segs_per_shard)
            for b in self._bufs:
                b.consume(self.chunk_len)
            self._consumed += self.chunk_len
            # Snapshot only after the buffer is trimmed, so a resume
            # replays nothing and skips nothing.
            if (
                self.checkpoint_path
                and self.checkpoint_every
                and self.metrics.chunks_done % self.checkpoint_every == 0
            ):
                self._snapshot()

    def _process(self, ext: np.ndarray, total_segs: int) -> None:
        """ext: (C, chunk_len + halo) — chunk plus its tail halo."""
        fdt = default_float()
        if self.channels == 1:  # preserve the scalar-signal jit signature
            ext = ext[0]
        if self._acc_s is None:
            z = np.zeros((self.channels, self.lp), dtype=fdt)
            self._acc_s = jax.device_put(z)
            self._acc_c = jax.device_put(z)
        ext_dev = jax.device_put(np.asarray(ext, dtype=fdt))
        self._acc_s, self._acc_c = _chunk_accumulate(
            ext_dev,
            self._w_pad,
            self._acc_s,
            self._acc_c,
            total_segs,
            self.mesh,
            self.nfft,
            self.fft_len,
            self.stride,
            self.segs_per_shard,
            self.lp,
            self.channels,
            self.chunk_len,
        )
        # The masked segment count is deterministic (== total_segs), so
        # nothing needs to be read back from the device here.
        self._count += float(total_segs)
        self.metrics.chunks_done += 1
        self.metrics.segments_done += int(total_segs)
        # dispatch is async (device accumulation, no readback): wall_s is
        # finalized as total elapsed in finalize().

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Flush the remainder and return (Pxx, freqs).

        The remainder is zero-padded to one chunk and its incomplete
        segments masked, so the final count equals the reference's
        (L-nfft)/stride+1 over the whole stream.
        """
        rem = np.stack([b.peek(len(b)) for b in self._bufs])
        if 0 < rem.shape[-1] < self.nfft and self._count == 0 and self.metrics.chunks_done == 0:
            # Whole stream shorter than nfft: the reference zero-pads to
            # one full segment (pwelch.go:97-99).
            rem = np.pad(rem, ((0, 0), (0, self.nfft - rem.shape[-1])))
        if rem.shape[-1] >= self.nfft:
            rem_segs = (rem.shape[-1] - self.nfft) // self.stride + 1
            padded = np.zeros(
                (self.channels, self.chunk_len + self.halo), dtype=self._np_float
            )
            padded[:, : rem.shape[-1]] = rem
            self._process(padded, total_segs=rem_segs)
            for b in self._bufs:
                b.consume(len(b))
        if self._t_first is not None:
            self.metrics.wall_s = time.perf_counter() - self._t_first
        acc = self._acc_read()
        pxx = acc / (self._count * self._w_norm) if self._count else acc
        freqs = np.arange(self.lp) * (self.fs / self.pad)
        log.info("finalize: %s", self.metrics.json_line())
        if self.channels == 1:
            pxx = pxx[0]
        return pxx, freqs


def stream_pwelch(
    blocks: Iterable[np.ndarray],
    fs: float,
    options: Optional[PwelchOptions] = None,
    mesh: Optional[Mesh] = None,
    **kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """One-call streaming Pwelch over an iterable of sample blocks."""
    sp = StreamingPwelch(fs, options, mesh, **kwargs)
    for b in blocks:
        sp.update(b)
    return sp.finalize()


def stream_welch(
    blocks: Iterable[np.ndarray],
    fs: float = 1.0,
    window="hann",
    nperseg: int = 256,
    noverlap: int | None = None,
    nfft: int | None = None,
    scaling: str = "density",
    mesh: Optional[Mesh] = None,
    **kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Streaming Welch PSD with scipy.signal.welch conventions
    (periodic windows, nperseg/noverlap/nfft vocabulary, density or
    spectrum scaling, mean average, no detrend): returns
    (freqs, Pxx) after consuming an iterable of sample blocks through
    the sharded StreamingPwelch driver.

    The nperseg-length PERIODIC window is zero-extended on demand, so
    the driver's pad-length-window slot reproduces scipy's
    window-then-zero-pad semantics for nfft > nperseg while the
    sum(w^2) normalization keeps the nperseg table — exactly scipy's
    scaling."""
    if scaling not in ("density", "spectrum"):
        raise ValueError("scaling must be 'density' or 'spectrum'")
    from godsp_tpu.spectral._welch_impl import _periodic_table_np

    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    wt = _periodic_table_np(window, nperseg)

    def wf(L: int, _wt=wt) -> np.ndarray:
        out = np.zeros(L)
        out[: min(L, len(_wt))] = _wt[: min(L, len(_wt))]
        return out

    opts = PwelchOptions(nfft=nperseg, window=wf, pad=nfft,
                         noverlap=noverlap)
    pxx, freqs = stream_pwelch(blocks, fs, opts, mesh, **kwargs)
    pxx = np.asarray(pxx).copy()
    if nfft % 2:  # scipy doubles every non-DC bin for odd lengths
        pxx[..., -1] *= 2.0
    if scaling == "spectrum":
        pxx *= float(fs) * float(np.sum(wt * wt)) / float(np.sum(wt)) ** 2
    return np.asarray(freqs), pxx
