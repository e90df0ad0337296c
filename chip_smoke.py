#!/usr/bin/env python3
"""Smoke check of godsp_tpu's signal chain on NVIDIA GPUs.

Drives the public API once at deployment sizes, scores every result
against a float64 numpy/scipy reference computed on the host, and prints
one line per result: shapes, SNR, compile seconds (first call minus a
steady call), steady median wall time, the device's peak bytes in use so
far, and the least bytes the operation must move with their share of the
HBM peak.  Every call is the public function as a user makes it.  Exits
non-zero, and prints no JSON line, when JAX finds no GPU, when a phase
raises, or when a result misses its bound.  On success the last line is
one JSON object:

  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage (from the repository root):

  python chip_smoke.py            # one GPU: every single-device phase
  python chip_smoke.py --four     # four GPUs: the sharded paths only

Inputs come from --seed; WAV files are written to a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from godsp_tpu import fft, models, native, parallel, spectral, wav
from godsp_tpu import window as win
from godsp_tpu.dsputils import snr_db
from godsp_tpu.utils import enable_compile_cache, trace_to
from godsp_tpu.utils.metrics import copy_floor, device_peaks, matmul_floor
from godsp_tpu.utils.oracles import csd_np, pwelch_np, tone_signal, tone_snr_db
from godsp_tpu.utils.profiling import device_event_ms

SNR_BOUND = 120.0  # dB against float64, float32 compute (x64 off)
SHARD_RTOL = 2e-4  # sharded result vs the same call on one device


@dataclass
class Row:
    """One scored result of a phase."""

    name: str
    shapes: str
    snr_db: Optional[float] = None
    bound_db: Optional[float] = SNR_BOUND
    compile_s: Optional[float] = None
    ms: Optional[float] = None
    peak_bytes: Optional[int] = None
    min_bytes: Optional[float] = None
    share: Optional[float] = None
    note: str = ""
    info: bool = False  # reported, never judged
    passed: bool = True  # checks beside the SNR bound (exactness, tolerance)

    @property
    def ok(self) -> bool:
        if self.info:
            return True
        snr_ok = self.bound_db is None or (
            self.snr_db is not None and self.snr_db >= self.bound_db)
        return self.passed and snr_ok

    def line(self) -> str:
        def f(v, fmt):
            return "n/a" if v is None else format(v, fmt)

        tag = "info" if self.info else ("PASS" if self.ok else "FAIL")
        bound = "" if self.info or self.bound_db is None else f">={self.bound_db:g}"
        return (
            f"[{tag}] {self.name} {self.shapes} snr_db={f(self.snr_db, '.1f')}{bound}"
            f" compile_s={f(self.compile_s, '.2f')} ms={f(self.ms, '.3f')}"
            f" peak_bytes={f(self.peak_bytes, 'd')} min_bytes={f(self.min_bytes, '.3e')}"
            f" hbm_share={f(self.share, '.3f')} {self.note}".rstrip()
        )


class Ctx:
    """What every phase needs: the rng, the device and its peaks, and a
    scratch directory for the files a phase writes."""

    def __init__(self, seed: int, tmpdir: str, peak_gbs: Optional[float] = None,
                 bf16_tflops: Optional[float] = None, reps: int = 5):
        self.rng = np.random.default_rng(seed)
        self.tmpdir = tmpdir
        self.peak_gbs = peak_gbs
        self.bf16_tflops = bf16_tflops
        self.reps = reps
        self.device = jax.devices()[0]

    def peak_bytes(self) -> Optional[int]:
        stats = self.device.memory_stats()
        return None if not stats else int(stats.get("peak_bytes_in_use", 0))

    def timed(self, fn: Callable, *args, reps: Optional[int] = None):
        """(result, compile_s, median_ms): first call, then reps steady
        calls, each ended by block_until_ready."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        walls = []
        for _ in range(reps or self.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            walls.append(time.perf_counter() - t0)
        med = statistics.median(walls)
        return out, max(first - med, 0.0), med * 1e3

    def row(self, name, shapes, snr, compile_s, ms, min_bytes=None, **kw) -> Row:
        share = None
        if min_bytes is not None and ms and self.peak_gbs:
            share = min_bytes / (ms * 1e-3) / (self.peak_gbs * 1e9)
        return Row(name, shapes, snr, compile_s=compile_s, ms=ms,
                   peak_bytes=self.peak_bytes(), min_bytes=min_bytes,
                   share=share, **kw)


def _cplx(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def _real(rng, n) -> np.ndarray:
    return rng.standard_normal(n).astype(np.float32)


# --------------------------------------------------------------------------
# Single-device phases.  Each takes its sizes as arguments so the CPU tests
# can run it at a tiny size; main() supplies the deployment sizes.
# --------------------------------------------------------------------------


def phase_fft(ctx: Ctx, batch=(16384, 1024), square=4096,
              singles=(1 << 20, 1 << 24)) -> list[Row]:
    """Batched complex/real FFTs, the inverse round trip, and single
    giant transforms, each beside jnp.fft (cuFFT on a GPU) as info."""
    rows = []
    fwd, inv, lib = fft.fft, fft.ifft, jax.jit(jnp.fft.fft)
    shapes = [batch, (square, square)] + [(n,) for n in singles]
    for shape in shapes:
        x = _cplx(ctx.rng, shape)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        xd = jnp.asarray(x)
        nbytes = 2.0 * x.nbytes
        y, c, ms = ctx.timed(fwd, xd)
        rows.append(ctx.row("fft.fft", f"c64{list(shape)}",
                            snr_db(np.asarray(y), ref), c, ms, nbytes))
        if len(shape) == 1 and shape[0] >= 1 << 16:
            tones = [(3, 0.5, 0.1), (shape[0] // 3 + 1, 0.25, -0.3),
                     ((shape[0] >> 1) + 7, 0.125, 0.7)]
            zt = jnp.asarray(tone_signal(shape[0], tones).astype(np.complex64))
            rows.append(Row("fft.fft[tones]", f"c64{list(shape)}",
                            tone_snr_db(np.asarray(fwd(zt)), tones),
                            note="closed-form multi-tone spectrum"))
        z, c, ms = ctx.timed(inv, y)
        rows.append(ctx.row("fft.ifft(fft)", f"c64{list(shape)}",
                            snr_db(np.asarray(z), x.astype(np.complex128)),
                            c, ms, nbytes))
        yl, c, ms = ctx.timed(lib, xd)
        rows.append(ctx.row("jnp.fft.fft", f"c64{list(shape)}",
                            snr_db(np.asarray(yl), ref), c, ms, nbytes,
                            info=True, note="library FFT, same input; route unchanged"))
        del xd, y, z, yl
    xr = _real(ctx.rng, batch)
    ref = np.fft.fft(xr.astype(np.float64), axis=-1)
    y, c, ms = ctx.timed(fft.fft_real, jnp.asarray(xr))
    rows.append(ctx.row("fft.fft_real", f"f32{list(batch)}",
                        snr_db(np.asarray(y), ref), c, ms, xr.nbytes * 3.0))
    yl, c, ms = ctx.timed(jax.jit(jnp.fft.rfft), jnp.asarray(xr))
    rows.append(ctx.row("jnp.fft.rfft", f"f32{list(batch)}",
                        snr_db(np.asarray(yl), ref[..., : batch[1] // 2 + 1]),
                        c, ms, xr.nbytes * 2.0, info=True,
                        note="library real FFT, same input; route unchanged"))
    return rows


def phase_bluestein(ctx: Ctx, sizes=(1000, 1331), batch=4096) -> list[Row]:
    rows = []
    for n in sizes:
        x = _cplx(ctx.rng, (batch, n))
        y, c, ms = ctx.timed(fft.fft, jnp.asarray(x))
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        rows.append(ctx.row("fft.fft[bluestein]", f"c64[{batch}, {n}]",
                            snr_db(np.asarray(y), ref), c, ms, 2.0 * x.nbytes))
    return rows


def phase_fft2_convolve(ctx: Ctx, n2d=4096, nconv=1 << 20) -> list[Row]:
    x = _cplx(ctx.rng, (n2d, n2d))
    y, c, ms = ctx.timed(fft.fft2, jnp.asarray(x))
    rows = [ctx.row("fft.fft2", f"c64[{n2d}, {n2d}]",
                    snr_db(np.asarray(y), np.fft.fft2(x.astype(np.complex128))),
                    c, ms, 2.0 * x.nbytes)]
    del y
    a, b = _cplx(ctx.rng, nconv), _cplx(ctx.rng, nconv)
    z, c, ms = ctx.timed(fft.convolve, jnp.asarray(a), jnp.asarray(b))
    ref = np.fft.ifft(np.fft.fft(a.astype(np.complex128)) * np.fft.fft(b.astype(np.complex128)))
    rows.append(ctx.row("fft.convolve", f"c64[{nconv}]x2",
                        snr_db(np.asarray(z), ref), c, ms, 3.0 * a.nbytes))
    return rows


def phase_pwelch(ctx: Ctx, n=1 << 26, geoms=((1024, 512), (512, 352)),
                 fs=16000.0) -> list[Row]:
    """spectral.pwelch over one long signal; (512, 352) is the 10 ms hop
    (160 samples) at 16 kHz."""
    rows = []
    x = _real(ctx.rng, n)
    xd = jnp.asarray(x)
    for nfft, nover in geoms:
        opts = spectral.PwelchOptions(nfft=nfft, noverlap=nover)
        p, c, ms = ctx.timed(lambda v, o=opts: spectral.pwelch(v, fs, o)[0], xd)
        ref = pwelch_np(x, fs, nfft, nover)
        rows.append(ctx.row("spectral.pwelch", f"f32[{n}] nfft={nfft} hop={nfft - nover}",
                            snr_db(np.asarray(p), ref), c, ms, float(x.nbytes)))
    # Cross spectrum of x with a delayed noisy copy, first geometry.
    nfft, nover = geoms[0]
    opts = spectral.PwelchOptions(nfft=nfft, noverlap=nover)
    y = (0.5 * np.roll(x, 7) + 0.5 * _real(ctx.rng, n)).astype(np.float32)
    pxy, c, ms = ctx.timed(lambda a, b: spectral.csd(a, b, fs, opts)[0], xd, jnp.asarray(y))
    rows.append(ctx.row("spectral.csd", f"f32[{n}]x2 nfft={nfft} hop={nfft - nover}",
                        snr_db(np.asarray(pxy), csd_np(x, y, fs, nfft, nover)), c, ms,
                        2.0 * x.nbytes))
    return rows


def phase_wav_psd(ctx: Ctx, n=1 << 26, fs=44100, nfft=1024,
                  noverlap=512, block_size=1 << 20, segs_per_chunk_shard=2048,
                  checkpoint_every=8) -> list[Row]:
    """16-bit PCM WAV -> models.wav_psd, once straight through (timed),
    once killed mid-stream with checkpoints on, then resumed by a new
    call from the checkpoint; both against the float64 one-shot Welch."""
    t = np.arange(n) / fs
    sig = 0.3 * np.sin(2 * np.pi * 1000.0 * t) + 0.1 * ctx.rng.standard_normal(n)
    pcm = np.clip(np.round(sig * 32767.0), -32768, 32767).astype(np.int16)
    path = os.path.join(ctx.tmpdir, "smoke.wav")
    wav.write_wav(path, pcm, fs)
    opts = spectral.PwelchOptions(nfft=nfft, noverlap=noverlap)
    kw = dict(block_size=block_size, segs_per_chunk_shard=segs_per_chunk_shard)
    decoded = (pcm.astype(np.float64) + 32768.0) / 65535.0  # wav.go:138-161
    ref = pwelch_np(decoded, float(fs), nfft, noverlap)

    res, c, ms = ctx.timed(lambda: models.wav_psd(path, opts, **kw), reps=2)
    msps = n / (ms * 1e-3) / 1e6
    rows = [ctx.row("models.wav_psd", f"pcm16[{n}] fs={fs} nfft={nfft}",
                    snr_db(res.pxx, ref), c, ms,
                    note=f"msamples_per_s={msps:.1f} native={native.available()}")]

    # The killed run: its stream ends halfway although the header
    # promises all the data, so reading fails mid-stream.
    ck = os.path.join(ctx.tmpdir, "smoke.ckpt.npz")
    with open(path, "rb") as f:
        head = f.read(os.path.getsize(path) // 2)
    try:
        models.wav_psd(head, opts, checkpoint_path=ck,
                       checkpoint_every_chunks=checkpoint_every, **kw)
        raise AssertionError("truncated stream did not fail")
    except EOFError:
        pass  # the simulated crash: the checkpoint holds the state so far
    if not os.path.exists(ck):
        raise AssertionError("the killed run left no checkpoint")
    resumed = models.wav_psd(path, opts, checkpoint_path=ck,
                             checkpoint_every_chunks=checkpoint_every, **kw)
    rows.append(Row("models.wav_psd[resume]", f"pcm16[{n}] killed at 1/2",
                    snr_db(resumed.pxx, ref), peak_bytes=ctx.peak_bytes(),
                    note="checkpoint/resume vs one-shot float64"))
    return rows


def phase_stft_istft(ctx: Ctx, n=1 << 24, nfft=1024, hop=256) -> list[Row]:
    x = _real(ctx.rng, n)
    xd = jnp.asarray(x)
    s, c, ms = ctx.timed(lambda v: models.stft(v, nfft, hop=hop), xd)
    frames = (n - nfft) // hop + 1
    wt = win.window_table_np("hann", nfft)
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    ref = np.fft.rfft(x.astype(np.float64)[idx] * wt, axis=-1)
    bins = nfft // 2 + 1
    rows = [ctx.row("models.stft", f"f32[{n}] nfft={nfft} hop={hop}",
                    snr_db(np.asarray(s), ref), c, ms,
                    4.0 * n + 8.0 * frames * bins)]
    del ref, idx
    y, c, ms = ctx.timed(lambda sp: models.istft(sp, nfft, hop=hop), s)
    y = np.asarray(y)
    span = slice(nfft, y.shape[-1] - nfft)  # Hann ends carry no weight
    rows.append(ctx.row("models.istft(stft)", f"c64[{frames}, {bins}]",
                        snr_db(y[span], x.astype(np.float64)[span]), c, ms,
                        8.0 * frames * bins + 4.0 * y.shape[-1],
                        note="round trip, interior"))
    return rows


def phase_mel(ctx: Ctx, n=1 << 24, fs=16000.0, win_len=400, nfft=512, hop=160,
              n_mels=80) -> list[Row]:
    """Log-mel front end at 16 kHz: a win_len Hann window inside an nfft
    FFT (the window zero-extended to nfft), hop 160 = 10 ms.  The mel
    power before the log is scored, which checks the filterbank matmul
    is not contracted in TF32."""
    w = np.zeros(nfft)
    w[:win_len] = win.window_table_np("hann", win_len)

    def window(length, _w=w):
        assert length == nfft
        return _w

    x = _real(ctx.rng, n)
    m, c, ms = ctx.timed(lambda v: models.mel_spectrogram(
        v, fs, nfft=nfft, hop=hop, n_mels=n_mels, window=window), jnp.asarray(x))
    frames = (n - nfft) // hop + 1
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    spec = np.fft.rfft(x.astype(np.float64)[idx] * w, axis=-1)
    fb = np.asarray(models.mel_filterbank(n_mels, nfft, fs), np.float64)
    ref = (spec.real**2 + spec.imag**2) @ fb.T
    return [ctx.row("models.mel_spectrogram", f"f32[{n}] win={win_len} nfft={nfft} "
                    f"hop={hop} mels={n_mels}", snr_db(np.asarray(m), ref), c, ms,
                    4.0 * n + 4.0 * frames * n_mels, note="mel power before log")]


def phase_floors(ctx: Ctx, copy_bytes=1 << 30, mm_n=8192) -> list[Row]:
    """What a plain copy and a large bf16 matrix product reach on this
    card, measured in the same process as the phases (info only)."""
    cp = copy_floor(copy_bytes)
    mm = matmul_floor(mm_n)
    ms = mm.wall_s * 1e3
    tflops = mm.flops / mm.wall_s / 1e12
    peak = ctx.bf16_tflops
    share = f" bf16_share={tflops / peak:.3f}" if peak else ""
    return [
        ctx.row("floor.copy", f"f32[{copy_bytes // 4}]", None, None, cp.wall_s * 1e3,
                cp.bytes_moved, info=True, note=f"gbs={cp.gbs:.1f}"),
        ctx.row("floor.matmul", f"bf16[{mm_n}, {mm_n}]^2", None, None, ms,
                info=True, note=f"tflops={tflops:.1f}{share}"),
    ]


def phase_transfer(ctx: Ctx, shape=(4096, 4096)) -> list[Row]:
    """complex64 host -> device with jnp.asarray and back with
    np.asarray must be bit-exact."""
    x = _cplx(ctx.rng, shape)
    t0 = time.perf_counter()
    d = jax.block_until_ready(jnp.asarray(x))
    back = np.asarray(d)
    ms = (time.perf_counter() - t0) * 1e3
    exact = back.dtype == x.dtype and np.array_equal(back.view(np.uint64), x.view(np.uint64))
    return [Row("transfer", f"c64{list(shape)}", bound_db=None, ms=ms,
                peak_bytes=ctx.peak_bytes(), passed=exact, note=f"bit_exact={exact}")]


# --------------------------------------------------------------------------
# Four-device phases (--four): each sharded call beside the same call on
# device 0 alone, and Welch also beside float64.
# --------------------------------------------------------------------------


def _rel_diff(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _shard_row(ctx, name, shapes, got, single, c, ms, min_bytes=None, ref=None):
    """Score a sharded result: the max-norm relative difference from the
    single-device call must be <= SHARD_RTOL; with a float64 ref, the SNR
    against it must also clear SNR_BOUND."""
    diff = _rel_diff(got, single)
    devs = sorted(d.id for d in got.sharding.device_set)
    note = f"vs_device0_rel={diff:.2e}<={SHARD_RTOL:g} devices={devs}"
    snr = snr_db(np.asarray(got), ref) if ref is not None else snr_db(
        np.asarray(got), np.asarray(single))
    return ctx.row(name, shapes, snr, c, ms, min_bytes, note=note,
                   passed=diff <= SHARD_RTOL)


def phase_four(ctx: Ctx, n=1 << 26, nfft=1024, noverlap=512,
               fs=16000.0, n_fft=1 << 26, stft_n=1 << 24, stft_nfft=1024,
               stft_hop=256, segs_per_chunk_shard=4096) -> list[Row]:
    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(jax.devices())}")
    dev0 = devs[0]
    mk = parallel.make_mesh
    rows = []
    opts = spectral.PwelchOptions(nfft=nfft, noverlap=noverlap)

    # Welch over 4 * n samples: (dp=1, sp=4) on one stream, (dp=2, sp=2)
    # on two streams of 2 * n.
    x = _real(ctx.rng, 4 * n)
    def single_fn(v):
        return spectral.pwelch(jax.device_put(v, dev0), fs, opts)[0]

    single = np.asarray(single_fn(x))
    ref = pwelch_np(x, fs, nfft, noverlap)
    mesh = mk(parallel.MeshConfig(dp=1, sp=4), devs)
    got, c, ms = ctx.timed(lambda v: parallel.pwelch_sharded(v, fs, opts, mesh)[0],
                           jnp.asarray(x))
    rows.append(_shard_row(ctx, "parallel.pwelch_sharded[dp=1,sp=4]", f"f32[{4 * n}]",
                           got, single, c, ms, float(x.nbytes), ref))
    x2 = x.reshape(2, 2 * n)
    single2 = np.asarray(single_fn(x2))
    ref2 = pwelch_np(x2, fs, nfft, noverlap)
    mesh2 = mk(parallel.MeshConfig(dp=2, sp=2), devs)
    got, c, ms = ctx.timed(lambda v: parallel.pwelch_sharded(v, fs, opts, mesh2)[0],
                           jnp.asarray(x2))
    rows.append(_shard_row(ctx, "parallel.pwelch_sharded[dp=2,sp=2]", f"f32[2, {2 * n}]",
                           got, single2, c, ms, float(x.nbytes), ref2))

    # Streaming Welch with one checkpoint/resume, over the same stream.
    ck = os.path.join(ctx.tmpdir, "four.ckpt.npz")
    blocks = np.array_split(x, 64)
    half = len(blocks) // 2
    a = parallel.StreamingPwelch(fs, opts, mesh, segs_per_chunk_shard=segs_per_chunk_shard,
                                 checkpoint_path=ck, checkpoint_every_chunks=1)
    for b in blocks[:half]:
        a.update(b)
    del a  # the "crash"
    t0 = time.perf_counter()
    b_drv = parallel.StreamingPwelch(fs, opts, mesh,
                                     segs_per_chunk_shard=segs_per_chunk_shard,
                                     checkpoint_path=ck)
    rest = np.concatenate(blocks)[b_drv.metrics.samples_in:]
    b_drv.update(rest)
    pxx, _ = b_drv.finalize()
    ms = (time.perf_counter() - t0) * 1e3
    diff = _rel_diff(pxx, single)
    rows.append(Row("parallel.StreamingPwelch[resume,sp=4]", f"f32[{4 * n}] 64 blocks",
                    snr_db(pxx, ref), ms=ms, peak_bytes=ctx.peak_bytes(),
                    passed=diff <= SHARD_RTOL,
                    note=f"vs_device0_rel={diff:.2e}<={SHARD_RTOL:g}"))
    del x, x2

    # Tensor-parallel FFT of one 2^26-point transform.
    z = _cplx(ctx.rng, n_fft)
    zref = np.fft.fft(z.astype(np.complex128))
    single = np.asarray(fft.fft(jax.device_put(z, dev0)))
    got, c, ms = ctx.timed(lambda v: parallel.fft_sharded(v, mesh), jnp.asarray(z))
    rows.append(_shard_row(ctx, "parallel.fft_sharded[sp=4]", f"c64[{n_fft}]",
                           got, single, c, ms, 2.0 * z.nbytes, zref))
    # One traced call: NCCL kernel time per device (the collectives).
    zd = jnp.asarray(z)
    trace_dir = os.path.join(ctx.tmpdir, "trace")
    with trace_to(trace_dir):
        jax.block_until_ready(parallel.fft_sharded(zd, mesh))
    coll = device_event_ms(trace_dir, ("nccl",))
    rows.append(Row("trace.nccl[fft_sharded]", f"c64[{n_fft}] one call", info=True,
                    note="collective_ms=" + json.dumps(
                        {k: round(v, 3) for k, v in sorted(coll.items())})))
    del z, zd, zref, single, got

    # Sequence-parallel spectrogram and ISTFT.
    xs = _real(ctx.rng, stft_n)
    single = np.asarray(models.spectrogram(jax.device_put(xs, dev0), stft_nfft, stft_hop))
    got, c, ms = ctx.timed(
        lambda v: parallel.spectrogram_sharded(v, mesh, stft_nfft, stft_hop), jnp.asarray(xs))
    rows.append(_shard_row(ctx, "parallel.spectrogram_sharded[sp=4]", f"f32[{stft_n}]",
                           got, single, c, ms))
    frames = ((stft_n - stft_nfft) // stft_hop + 1) // 4 * 4
    spec_host = np.asarray(models.stft(jax.device_put(xs, dev0), stft_nfft,
                                       hop=stft_hop))[:frames]
    single = np.asarray(models.istft(jax.device_put(spec_host, dev0), stft_nfft,
                                     hop=stft_hop))[: frames * stft_hop]
    got, c, ms = ctx.timed(
        lambda s: parallel.istft_sharded(s, mesh, stft_nfft, stft_hop), jnp.asarray(spec_host))
    rows.append(_shard_row(ctx, "parallel.istft_sharded[sp=4]", f"c64[{frames}, "
                           f"{stft_nfft // 2 + 1}]", got, single, c, ms))
    return rows


SINGLE = {
    "transfer": phase_transfer,
    "floors": phase_floors,
    "fft": phase_fft,
    "bluestein": phase_bluestein,
    "fft2_convolve": phase_fft2_convolve,
    "pwelch": phase_pwelch,
    "wav_psd": phase_wav_psd,
    "stft_istft": phase_stft_istft,
    "mel": phase_mel,
}


def gpu_name_and_power() -> str:
    """The card's name and power limit, read by nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def run_phases(ctx: Ctx, phases: dict) -> bool:
    """Run each phase, print its rows; a phase that raises is reported
    with its traceback and counts as failed.  Returns all-ok."""
    ok = True
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            rows = fn(ctx)
        except Exception:
            print(f"[FAIL] phase {name} raised:", flush=True)
            traceback.print_exc(file=sys.stdout)
            ok = False
            continue
        for r in rows:
            print(r.line(), flush=True)
            ok = ok and r.ok
        print(f"phase {name} done in {time.perf_counter() - t0:.1f} s", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device sharded phases")
    args = ap.parse_args(argv)

    enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found platform "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    kind = devices[0].device_kind
    peaks = device_peaks(devices[0])  # unknown device -> KeyError
    print(f"gpu: {gpu_name_and_power()}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {kind}, hbm peak "
          f"{peaks['hbm_gbs']:.0f} GB/s, x64={jax.config.jax_enable_x64}", flush=True)
    print(f"native host ops: {native.available()}", flush=True)

    phases = {"four": phase_four} if args.four else SINGLE
    with tempfile.TemporaryDirectory() as tmpdir:
        ctx = Ctx(args.seed, tmpdir, peaks["hbm_gbs"], peaks["bf16_tflops"])
        ok = run_phases(ctx, phases)
    if not ok:
        print("chip_smoke: FAILED", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind, "count": len(devices)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
