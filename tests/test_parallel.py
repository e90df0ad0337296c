"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4):
sharded Pwelch must equal single-device Pwelch within tolerance, halo
logic included; streaming must equal one-shot on the same data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu import spectral
from godsp_tpu.parallel import (
    MeshConfig,
    StreamingPwelch,
    make_mesh,
    pwelch_sharded,
    stream_pwelch,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (
        np.sin(2 * np.pi * 0.01 * t) + 0.5 * np.sin(2 * np.pi * 0.1 * t) + rng.normal(size=n)
    )


class TestShardedPwelch:
    @pytest.mark.parametrize("noverlap", [0, 64, 128, 255])
    def test_matches_single_device(self, noverlap):
        opts = spectral.PwelchOptions(nfft=256, noverlap=noverlap)
        stride = 256 - noverlap
        # block per shard must hold the noverlap-sample halo
        segs_per_shard = max(16, -(-noverlap // stride) + 1)
        L = 8 * stride * segs_per_shard
        x = jnp.asarray(_signal(L))
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        p_sh, f_sh = pwelch_sharded(x, 2.0, opts, mesh)
        p_1, f_1 = spectral.pwelch(x, 2.0, opts)
        np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_1), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(f_sh), np.asarray(f_1))

    def test_dp_sp_mesh_batch(self):
        opts = spectral.PwelchOptions(nfft=128, noverlap=64)
        L = 4 * 64 * 32
        xb = jnp.asarray(np.stack([_signal(L, 1), _signal(L, 2)]))
        mesh = make_mesh(MeshConfig(dp=2, sp=4))
        pb, _ = pwelch_sharded(xb, 1.0, opts, mesh)
        assert pb.shape == (2, 65)
        for i in range(2):
            ref, _ = spectral.pwelch(xb[i], 1.0, opts)
            np.testing.assert_allclose(np.asarray(pb[i]), np.asarray(ref), rtol=1e-10)

    def test_indivisible_length_raises(self):
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        with pytest.raises(ValueError, match="divisible"):
            pwelch_sharded(jnp.ones(1000), 1.0, spectral.PwelchOptions(nfft=256), mesh)

    def test_pad_gt_nfft_sharded(self):
        opts = spectral.PwelchOptions(nfft=128, pad=256, noverlap=0)
        L = 8 * 128 * 4
        x = jnp.asarray(_signal(L))
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        p_sh, _ = pwelch_sharded(x, 1.0, opts, mesh)
        p_1, _ = spectral.pwelch(x, 1.0, opts)
        np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_1), rtol=1e-10)


class TestStreaming:
    def test_stream_equals_oneshot(self):
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        L = 100_000  # deliberately not chunk-aligned
        x = _signal(L)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        blocks = [x[i : i + 7777] for i in range(0, L, 7777)]
        pxx, freqs = stream_pwelch(blocks, 2.0, opts, mesh, segs_per_chunk_shard=8)
        ref, ref_f = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        np.testing.assert_allclose(pxx, np.asarray(ref), rtol=1e-9)
        np.testing.assert_allclose(freqs, np.asarray(ref_f))

    def test_stream_short_input(self):
        opts = spectral.PwelchOptions(nfft=256)
        x = _signal(100)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        pxx, freqs = stream_pwelch([x], 2.0, opts, mesh, segs_per_chunk_shard=4)
        ref, _ = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        np.testing.assert_allclose(pxx, np.asarray(ref), rtol=1e-9)

    def test_checkpoint_resume(self, tmp_path):
        opts = spectral.PwelchOptions(nfft=128, noverlap=64)
        x = _signal(60_000)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        ckpt = str(tmp_path / "state.npz")

        # Run A: process half, checkpointing every chunk, then "crash".
        a = StreamingPwelch(
            2.0, opts, mesh, segs_per_chunk_shard=8,
            checkpoint_path=ckpt, checkpoint_every_chunks=1,
        )
        a.update(x[:30_000])
        done_chunks = a.metrics.chunks_done
        assert done_chunks > 0

        # Run B: resume from the checkpoint, replay the unconsumed tail.
        b = StreamingPwelch(
            2.0, opts, mesh, segs_per_chunk_shard=8,
            checkpoint_path=ckpt, checkpoint_every_chunks=1,
        )
        assert b.metrics.chunks_done == done_chunks
        consumed = b.metrics.chunks_done * b.chunk_len - len(b._buf)
        # feed everything after what run A had folded in at its last snapshot
        fed_to_a = 30_000
        already = b.metrics.chunks_done * b.chunk_len + len(b._buf)
        b.update(x[already:])
        pxx, _ = b.finalize()
        ref, _ = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        np.testing.assert_allclose(pxx, np.asarray(ref), rtol=1e-9)

    def test_metrics(self):
        opts = spectral.PwelchOptions(nfft=128)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        sp = StreamingPwelch(1.0, opts, mesh, segs_per_chunk_shard=4)
        sp.update(_signal(20_000))
        sp.finalize()
        assert sp.metrics.samples_in == 20_000
        assert sp.metrics.segments_done > 0
        assert sp.metrics.wall_s > 0
        assert "msamples_per_s" in sp.metrics.json_line()


class TestShardedFFT:
    """Tensor-parallel four-step FFT (parallel/fft_sharded.py) vs numpy."""

    def test_natural_order_matches_numpy(self):
        from godsp_tpu.parallel import fft_sharded

        n = 1 << 15
        rng = np.random.default_rng(0)
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex128)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got = np.asarray(fft_sharded(jnp.asarray(x), mesh))
        ref = np.fft.fft(x)
        from godsp_tpu.dsputils import snr_db

        assert snr_db(got, ref) >= 200.0  # f64 on the CPU mesh

    def test_digit_order(self):
        from godsp_tpu.parallel import fft_sharded

        n, p = 1 << 12, 8
        rng = np.random.default_rng(1)
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex128)
        mesh = make_mesh(MeshConfig(dp=1, sp=p))
        got = np.asarray(fft_sharded(jnp.asarray(x), mesh, order="digit"))
        ref = np.fft.fft(x)
        n2 = n // p
        # digit layout: position k1*n2 + k2 holds Y[k1 + p*k2]
        ref_digit = ref.reshape(n2, p).T.reshape(n)
        from godsp_tpu.dsputils import snr_db

        assert snr_db(got, ref_digit) >= 200.0

    def test_inverse_roundtrip(self):
        from godsp_tpu.parallel import fft_sharded

        n = 1 << 12
        rng = np.random.default_rng(2)
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex128)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        X = fft_sharded(jnp.asarray(x), mesh)
        back = np.asarray(fft_sharded(X, mesh, inverse=True)) / n
        from godsp_tpu.dsputils import snr_db

        assert snr_db(back, x) >= 200.0

    def test_batched(self):
        """Leading axes carried along; every row matches numpy."""
        from godsp_tpu.dsputils import snr_db
        from godsp_tpu.parallel import fft_sharded

        n = 1 << 12
        rng = np.random.default_rng(3)
        x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n)))
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got = np.asarray(fft_sharded(jnp.asarray(x), mesh))
        assert got.shape == (3, n)
        assert snr_db(got, np.fft.fft(x, axis=-1)) >= 200.0

    def test_uneven_psum_scatter_path(self):
        """n2 % p != 0 (here n2 < p): the reduce-scatter step-1 path."""
        from godsp_tpu.dsputils import snr_db
        from godsp_tpu.parallel import fft_sharded

        p = 8
        n = p * 4  # n2 = 4 < p: all_to_all split impossible
        rng = np.random.default_rng(4)
        x = rng.normal(size=n) + 1j * rng.normal(size=n)
        mesh = make_mesh(MeshConfig(dp=1, sp=p))
        got = np.asarray(fft_sharded(jnp.asarray(x), mesh))
        assert snr_db(got, np.fft.fft(x)) >= 200.0
        # digit order + round trip on the same path
        X = fft_sharded(jnp.asarray(x), mesh, order="digit")
        n2 = n // p
        ref_digit = np.fft.fft(x).reshape(n2, p).T.reshape(n)
        assert snr_db(np.asarray(X), ref_digit) >= 200.0

    def test_errors(self):
        from godsp_tpu.parallel import fft_sharded

        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        with pytest.raises(ValueError, match="divisible"):
            fft_sharded(jnp.ones(1001, jnp.complex128), mesh)
        with pytest.raises(ValueError, match="power of 2"):
            fft_sharded(jnp.ones(1000, jnp.complex128), mesh)  # n2 = 125
        with pytest.raises(ValueError, match="unknown order"):
            fft_sharded(jnp.ones(4096, jnp.complex128), mesh, order="x")


class TestMultichannelStreaming:
    def test_channels_match_per_channel_pwelch(self):
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        C, L = 4, 50_000
        x = np.stack([_signal(L, seed=s) for s in range(C)])
        mesh = make_mesh(MeshConfig(dp=2, sp=4))
        sp = StreamingPwelch(2.0, opts, mesh, segs_per_chunk_shard=8, channels=C)
        for i in range(0, L, 9999):
            sp.update(x[:, i : i + 9999])
        pxx, freqs = sp.finalize()
        assert pxx.shape == (C, 129)
        for c in range(C):
            ref, _ = spectral.pwelch(jnp.asarray(x[c]), 2.0, opts)
            np.testing.assert_allclose(pxx[c], np.asarray(ref), rtol=1e-9)

    def test_channel_shape_validation(self):
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        sp = StreamingPwelch(
            1.0, spectral.PwelchOptions(nfft=128), mesh,
            segs_per_chunk_shard=4, channels=3,
        )
        with pytest.raises(ValueError, match="expected"):
            sp.update(np.zeros(100))
        with pytest.raises(ValueError, match="channels"):
            StreamingPwelch(
                1.0, spectral.PwelchOptions(nfft=128),
                make_mesh(MeshConfig(dp=2, sp=4)),
                segs_per_chunk_shard=4, channels=3,
            )

    def test_multichannel_checkpoint_resume(self, tmp_path):
        opts = spectral.PwelchOptions(nfft=128, noverlap=64)
        C, L = 2, 40_000
        x = np.stack([_signal(L, seed=s + 10) for s in range(C)])
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        ckpt = str(tmp_path / "mc.npz")
        a = StreamingPwelch(
            2.0, opts, mesh, segs_per_chunk_shard=8, channels=C,
            checkpoint_path=ckpt, checkpoint_every_chunks=1,
        )
        a.update(x[:, :20_000])
        assert a.metrics.chunks_done > 0
        b = StreamingPwelch(
            2.0, opts, mesh, segs_per_chunk_shard=8, channels=C,
            checkpoint_path=ckpt, checkpoint_every_chunks=1,
        )
        already = b.metrics.chunks_done * b.chunk_len + len(b._bufs[0])
        b.update(x[:, already:])
        pxx, _ = b.finalize()
        for c in range(C):
            ref, _ = spectral.pwelch(jnp.asarray(x[c]), 2.0, opts)
            np.testing.assert_allclose(pxx[c], np.asarray(ref), rtol=1e-9)


class TestShardedSpectrogram:
    def test_matches_single_device(self):
        from godsp_tpu.models import spectrogram
        from godsp_tpu.parallel import spectrogram_sharded

        nfft, hop = 256, 128
        L = 8 * hop * 16
        x = jnp.asarray(_signal(L))
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got = np.asarray(spectrogram_sharded(x, mesh, nfft, hop))
        ref = np.asarray(spectrogram(x, nfft, hop))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-30)

    def test_pad_and_window(self):
        from godsp_tpu.models import spectrogram
        from godsp_tpu.parallel import spectrogram_sharded

        nfft, hop, pad = 128, 64, 256
        L = 8 * hop * 8
        x = jnp.asarray(_signal(L, seed=3))
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got = np.asarray(
            spectrogram_sharded(x, mesh, nfft, hop, window="hamming", pad=pad)
        )
        ref = np.asarray(spectrogram(x, nfft, hop, window="hamming", pad=pad))
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-30)

    def test_errors(self):
        from godsp_tpu.parallel import spectrogram_sharded

        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        with pytest.raises(ValueError, match="divide"):
            spectrogram_sharded(jnp.ones(1000), mesh, 256)


class TestShardedISTFT:
    """Frame-sharded synthesis == unsharded istft on the covered block."""

    def test_matches_single_device(self):
        from godsp_tpu.models import istft, stft
        from godsp_tpu.parallel import istft_sharded

        nfft, hop = 256, 128
        F = 8 * 16  # frames, multiple of n_sp
        L = (F - 1) * hop + nfft
        x = jnp.asarray(_signal(L))
        s = stft(x, nfft, hop=hop)[:F]
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got = np.asarray(istft_sharded(s, mesh, nfft, hop))
        ref = np.asarray(istft(s, nfft, hop))[: F * hop]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)

    def test_window_hop_eq_nfft_and_batched(self):
        from godsp_tpu.models import istft, stft
        from godsp_tpu.parallel import istft_sharded

        nfft = hop = 128  # H == 0: no exchange
        F = 8 * 4
        L = (F - 1) * hop + nfft
        rng = np.random.default_rng(7)
        xb = jnp.asarray(rng.normal(size=(2, L)))
        s = stft(xb, nfft, hop=hop, window="hamming")[..., :F, :]
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        got = np.asarray(istft_sharded(s, mesh, nfft, hop, window="hamming"))
        ref = np.asarray(istft(s, nfft, hop, window="hamming"))[..., : F * hop]
        assert got.shape == (2, F * hop)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)

    def test_roundtrip_interior(self):
        """Analysis -> sharded synthesis reconstructs the interior."""
        from godsp_tpu.models import stft
        from godsp_tpu.parallel import istft_sharded
        from godsp_tpu.dsputils import snr_db

        nfft, hop = 256, 64  # 75% overlap: H = 192 > hop
        F = 8 * 8
        L = (F - 1) * hop + nfft
        x = np.asarray(_signal(L))
        s = stft(jnp.asarray(x), nfft, hop=hop)[:F]
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        y = np.asarray(istft_sharded(s, mesh, nfft, hop))
        assert snr_db(y[1:], x[1 : F * hop]) >= 200.0

    def test_errors(self):
        from godsp_tpu.parallel import istft_sharded

        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        s = jnp.ones((20, 129), jnp.complex128)  # 20 not divisible by 8
        with pytest.raises(ValueError, match="multiple of n_sp"):
            istft_sharded(s, mesh, 256, 128)
        with pytest.raises(ValueError, match="hop <= nfft"):
            istft_sharded(jnp.ones((8, 129), jnp.complex128), mesh, 256, 512)
        with pytest.raises(ValueError, match="spill"):
            # fps*hop = 1*16 < nfft - hop = 240
            istft_sharded(jnp.ones((8, 129), jnp.complex128), mesh, 256, 16)
        with pytest.raises(ValueError, match="inconsistent"):
            istft_sharded(jnp.ones((8, 100), jnp.complex128), mesh, 256, 128,
                          pad=256)


class TestStreamingPadLtNfft:
    def test_stream_pad_lt_nfft(self):
        """Streaming reproduces the pad < nfft head-bins semantics."""
        opts = spectral.PwelchOptions(nfft=256, pad=128, noverlap=0)
        L = 60_000
        x = _signal(L, seed=11)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        pxx, freqs = stream_pwelch(
            [x[i : i + 9000] for i in range(0, L, 9000)],
            2.0, opts, mesh, segs_per_chunk_shard=8,
        )
        ref, ref_f = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        assert pxx.shape == (65,)
        np.testing.assert_allclose(pxx, np.asarray(ref), rtol=1e-9)
        np.testing.assert_allclose(freqs, np.asarray(ref_f))


class TestPpermuteHaloGeometries:
    """The halo geometries the removed in-kernel halo copy was tested
    at, through the ppermute halo that is now the only one."""

    def test_multichannel_sp_only(self):
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        L = 8 * 128 * 16
        x = np.stack([_signal(L, seed=20 + c) for c in range(3)])
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        p, _ = pwelch_sharded(jnp.asarray(x), 2.0, opts, mesh)
        assert p.shape == (3, 129)
        for c in range(3):
            ref, _ = spectral.pwelch(jnp.asarray(x[c]), 2.0, opts)
            np.testing.assert_allclose(np.asarray(p[c]), np.asarray(ref), rtol=1e-10)

    def test_global_tail_mask(self):
        """noverlap > stride: the last shard's final segments straddle
        the global end and must be masked, not filled from the ring."""
        opts = spectral.PwelchOptions(nfft=512, noverlap=384)
        x = jnp.asarray(_signal(8 * 128 * 8, seed=5))
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        p, _ = pwelch_sharded(x, 2.0, opts, mesh)
        ref, _ = spectral.pwelch(x, 2.0, opts)
        np.testing.assert_allclose(np.asarray(p), np.asarray(ref), rtol=1e-10)

    def test_stream_chunks_and_ragged_remainder(self):
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        L = 8 * 128 * 16 * 3 + 7000  # three chunks + ragged remainder
        x = _signal(L, seed=13)
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        pxx, _ = stream_pwelch([x[i : i + 9001] for i in range(0, L, 9001)],
                               2.0, opts, mesh, segs_per_chunk_shard=16)
        ref, _ = spectral.pwelch(jnp.asarray(x), 2.0, opts)
        np.testing.assert_allclose(pxx, np.asarray(ref), rtol=1e-9)

    def test_stream_stereo_sp_only(self):
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        L = 8 * 128 * 16 * 2 + 5000
        xs = np.stack([_signal(L, seed=31), _signal(L, seed=32)])
        mesh = make_mesh(MeshConfig(dp=1, sp=8))
        sp = StreamingPwelch(2.0, opts, mesh, segs_per_chunk_shard=16, channels=2)
        for i in range(0, L, 9001):
            sp.update(xs[:, i : i + 9001])
        pxx, _ = sp.finalize()
        for c in range(2):
            ref, _ = spectral.pwelch(jnp.asarray(xs[c]), 2.0, opts)
            np.testing.assert_allclose(pxx[c], np.asarray(ref), rtol=1e-9)


class TestSharded2DConvolution:
    """The separable 2-D convolution chain under dp sharding: a batch of
    images convolved shard-locally must equal the single-device result."""

    def test_dp_sharded_convolve2d(self):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from godsp_tpu.models import convolve2d

        rng = np.random.default_rng(0)
        imgs = rng.normal(size=(8, 24, 17)).astype(np.float64)
        kern = rng.normal(size=(5, 4))
        single = np.asarray(convolve2d(imgs, kern, mode="same"))

        devices = np.asarray(jax.devices()[:8])
        mesh = Mesh(devices, axis_names=("dp",))
        sharded_in = jax.device_put(
            imgs, NamedSharding(mesh, P("dp", None, None)))
        out = convolve2d(sharded_in, kern, mode="same")
        np.testing.assert_allclose(np.asarray(out), single,
                                   rtol=1e-10, atol=1e-12)


class TestStreamWelch:
    """stream_welch: scipy-convention streaming Welch over the sharded
    driver (periodic windows, density/spectrum scaling, odd-nfft
    doubling) — exact parity with one-shot scipy.welch(detrend=False)."""

    @pytest.mark.parametrize("kw", [
        dict(nperseg=256),
        dict(nperseg=256, noverlap=64, nfft=512),
        dict(nperseg=255, nfft=255),
        dict(nperseg=256, scaling="spectrum"),
    ])
    def test_scipy_parity(self, kw):
        import scipy.signal as ss

        from godsp_tpu.parallel import stream_welch

        rng = np.random.default_rng(0)
        x = rng.normal(size=1 << 16)
        # chunk sizes deliberately unaligned with the segment stride
        blocks = [x[i : i + 7000] for i in range(0, len(x), 7000)]
        f1, p1 = stream_welch(iter(blocks), fs=4.0, **kw)
        f2, p2 = ss.welch(x, fs=4.0, detrend=False, **kw)
        assert f1.shape == f2.shape
        np.testing.assert_allclose(p1, p2, rtol=1e-10, atol=1e-14)

    def test_validation(self):
        from godsp_tpu.parallel import stream_welch

        with pytest.raises(ValueError):
            stream_welch(iter([np.zeros(512)]), nperseg=256, nfft=128)
        with pytest.raises(ValueError):
            stream_welch(iter([np.zeros(512)]), scaling="bogus")
