"""Model-family tests: STFT/ISTFT/spectrogram + the WAV->PSD pipeline.

Validated against scipy.signal (an oracle the reference never had,
SURVEY.md §4) and against the framework's own Pwelch.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu import spectral, wav
from godsp_tpu.dsputils import snr_db
from godsp_tpu.models import (
    istft,
    spectrogram,
    spectrogram_from_wav,
    stft,
    stft_frames,
    wav_psd,
)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.sin(2 * np.pi * 0.03 * t) + 0.3 * rng.normal(size=n)


class TestSTFT:
    def test_shape_and_frame_geometry(self):
        x = _signal(1000)
        s = stft(x, nfft=256, hop=128)
        # (1000 - 256)//128 + 1 = 6 frames (spectral.go:26-33 geometry)
        assert s.shape == (6, 129)
        assert np.iscomplexobj(np.asarray(s))

    def test_frames_match_manual(self):
        x = np.arange(64, dtype=np.float64)
        f = np.asarray(stft_frames(jnp.asarray(x), 16, 8))
        assert f.shape == (7, 16)
        np.testing.assert_array_equal(f[2], x[16:32])

    def test_vs_scipy(self):
        scipy_signal = pytest.importorskip("scipy.signal")
        x = _signal(4096)
        nfft, hop = 256, 128
        got = np.asarray(stft(x, nfft, hop, window="hann"))
        w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(nfft) / (nfft - 1)))
        _, _, Z = scipy_signal.stft(
            x, window=w, nperseg=nfft, noverlap=nfft - hop, boundary=None,
            padded=False, return_onesided=True, scaling="spectrum",
        )
        ref = (Z * w.sum()).T  # undo scipy's 1/win.sum() scaling
        assert got.shape == ref.shape
        assert snr_db(got, ref) >= 100.0

    def test_istft_roundtrip_hann(self):
        x = _signal(2048)
        nfft, hop = 256, 64
        s = stft(x, nfft, hop)
        y = np.asarray(istft(s, nfft, hop))
        n_frames = (2048 - nfft) // hop + 1
        covered = (n_frames - 1) * hop + nfft
        # Hann is zero at its endpoints, so the very first/last covered
        # sample has zero synthesis weight and is unrecoverable.
        assert snr_db(y[1:-1], x[1 : covered - 1]) >= 100.0

    def test_istft_roundtrip_hamming_50(self):
        x = _signal(1024)
        s = stft(x, 128, 64, window="hamming")
        y = np.asarray(istft(s, 128, 64, window="hamming"))
        assert snr_db(y, x[: len(y)]) >= 100.0

    def test_istft_roundtrip_odd_pad(self):
        """Odd one-sided pad must be passed to istft explicitly (as
        scipy's irfft takes n); the even default would silently rebuild
        a (pad-1)-point spectrum."""
        x = _signal(1024)
        nfft, hop, pad = 128, 64, 135  # odd pad >= nfft (Bluestein path)
        s = stft(x, nfft, hop, window="hamming", pad=pad)
        assert s.shape[-1] == pad // 2 + 1
        y = np.asarray(istft(s, nfft, hop, window="hamming", pad=pad))
        assert snr_db(y, x[: len(y)]) >= 100.0
        with np.testing.assert_raises(ValueError):
            istft(s, nfft, hop, window="hamming", pad=pad + 1)

    def test_batched(self):
        xb = np.stack([_signal(512, 1), _signal(512, 2)])
        s = stft(xb, 128, 64)
        assert s.shape == (2, 7, 65)
        s0 = stft(xb[0], 128, 64)
        np.testing.assert_allclose(np.asarray(s[0]), np.asarray(s0), rtol=1e-12)

    def test_spectrogram_scales(self):
        x = _signal(512)
        p = np.asarray(spectrogram(x, 128, 64, scale="power"))
        m = np.asarray(spectrogram(x, 128, 64, scale="magnitude"))
        db = np.asarray(spectrogram(x, 128, 64, scale="db"))
        assert (p >= 0).all()
        np.testing.assert_allclose(m * m, p, rtol=1e-5)
        np.testing.assert_allclose(db, 10 * np.log10(np.maximum(p, 1e-20)), rtol=1e-5)
        with pytest.raises(ValueError, match="unknown scale"):
            spectrogram(x, 128, scale="weird")

    def test_spectrogram_mean_matches_pwelch(self):
        """With pwelch defaults (pad=nfft), averaged |STFT|^2 == Pwelch
        up to its normalization (pwelch.go:113-136)."""
        x = _signal(4096)
        nfft, hop, fs = 256, 128, 2.0
        p = np.asarray(spectrogram(x, nfft, hop)).mean(axis=0)
        lp = nfft // 2 + 1
        doubler = np.ones(lp); doubler[1:-1] = 2.0
        from godsp_tpu import window as win

        w = win.window_table_np("hann", nfft)
        mine = p * doubler / (np.sum(w * w) * fs)
        ref, _ = spectral.pwelch(
            x, fs, spectral.PwelchOptions(nfft=nfft, noverlap=nfft - hop)
        )
        assert snr_db(mine, np.asarray(ref)) >= 100.0

    def test_errors(self):
        with pytest.raises(ValueError, match="hop must be positive"):
            stft_frames(jnp.zeros(100), 16, 0)
        with pytest.raises(ValueError, match="signal length"):
            stft_frames(jnp.zeros(10), 16, 8)
        with pytest.raises(ValueError, match="pad must be"):
            stft(np.zeros(100), nfft=64, pad=32)


class TestWavPipeline:
    def _wav_bytes(self, n=20000, fs=8000):
        buf = io.BytesIO()
        sig = (_signal(n) * 0.2).astype(np.float32)
        wav.write_wav(buf, sig, fs)
        return buf.getvalue(), sig

    def test_wav_psd_matches_pwelch(self):
        data, sig = self._wav_bytes()
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        res = wav_psd(data, opts, block_size=4096)
        ref, freqs = spectral.pwelch(sig.astype(np.float64), 8000.0, opts)
        assert res.sample_rate == 8000
        assert res.samples == 20000
        np.testing.assert_allclose(res.pxx, np.asarray(ref), rtol=1e-5)
        np.testing.assert_allclose(res.freqs, np.asarray(freqs))
        assert '"samples_in": 20000' in res.metrics_json or "20000" in res.metrics_json

    @pytest.mark.parametrize("block_size", [4096, 3001])
    def test_wav_psd_resumes_from_checkpoint(self, tmp_path, block_size):
        """A run killed mid-stream (its stream ends before the header's
        data size) leaves a checkpoint; a new call resumes after the
        samples the snapshot accounts for and matches the one-shot
        result (block sizes aligned and not with the chunk)."""
        data, sig = self._wav_bytes(n=60000)
        opts = spectral.PwelchOptions(nfft=256, noverlap=128)
        ck = str(tmp_path / "psd.npz")
        kw = dict(block_size=block_size, segs_per_chunk_shard=8,
                  checkpoint_path=ck, checkpoint_every_chunks=2)
        with pytest.raises(EOFError):
            wav_psd(data[: len(data) // 2], opts, **kw)
        res = wav_psd(data, opts, **kw)
        ref, _ = spectral.pwelch(sig.astype(np.float64), 8000.0, opts)
        np.testing.assert_allclose(res.pxx, np.asarray(ref), rtol=1e-5)

    def test_spectrogram_from_wav(self):
        data, sig = self._wav_bytes(n=8192)
        s, freqs, times = spectrogram_from_wav(data, nfft=512, hop=256)
        n_frames = (8192 - 512) // 256 + 1
        assert np.asarray(s).shape == (n_frames, 257)
        assert freqs.shape == (257,)
        assert times.shape == (n_frames,)
        assert freqs[-1] == pytest.approx(4000.0)

    def test_reference_fixture(self, reference_wav_dir):
        res = wav_psd(
            f"{reference_wav_dir}/small.wav",
            spectral.PwelchOptions(nfft=1024, noverlap=512),
        )
        assert res.sample_rate == 44100
        assert res.samples == 41888  # wav_test.go:60-79
        assert res.pxx.shape == (513,)
        assert np.isfinite(res.pxx).all() and (res.pxx >= 0).all()


class TestFilter:
    """models.filter vs numpy/scipy oracles."""

    def test_fftconvolve_modes(self):
        scipy_signal = pytest.importorskip("scipy.signal")
        rng = np.random.default_rng(0)
        a = rng.normal(size=300)
        b = rng.normal(size=41)
        from godsp_tpu.models import fftconvolve

        for mode in ("full", "same", "valid"):
            got = np.asarray(fftconvolve(a, b, mode=mode))
            ref = scipy_signal.fftconvolve(a, b, mode=mode)
            assert got.shape == ref.shape
            assert snr_db(got, ref) >= 180.0

    def test_fftconvolve_complex_and_batched(self):
        rng = np.random.default_rng(1)
        a = rng.normal(size=(3, 100)) + 1j * rng.normal(size=(3, 100))
        b = rng.normal(size=(3, 20)) + 1j * rng.normal(size=(3, 20))
        from godsp_tpu.models import fftconvolve

        got = np.asarray(fftconvolve(a, b))
        for i in range(3):
            assert snr_db(got[i], np.convolve(a[i], b[i])) >= 180.0

    def test_fir_filter_matches_lfilter(self):
        scipy_signal = pytest.importorskip("scipy.signal")
        rng = np.random.default_rng(2)
        x = rng.normal(size=5000)
        taps = scipy_signal.firwin(63, 0.25)
        from godsp_tpu.models import fir_filter

        got = np.asarray(fir_filter(x, taps))
        ref = scipy_signal.lfilter(taps, [1.0], x)
        assert got.shape == ref.shape
        assert snr_db(got, ref) >= 180.0

    @pytest.mark.parametrize("L", [100, 4096, 20_000])
    def test_overlap_save_equals_fir(self, L):
        scipy_signal = pytest.importorskip("scipy.signal")
        rng = np.random.default_rng(L)
        x = rng.normal(size=L)
        taps = scipy_signal.firwin(101, 0.1)
        from godsp_tpu.models import overlap_save

        got = np.asarray(overlap_save(x, taps))
        ref = scipy_signal.lfilter(taps, [1.0], x)
        assert got.shape == ref.shape
        assert snr_db(got, ref) >= 170.0

    def test_overlap_save_batched_custom_block(self):
        rng = np.random.default_rng(9)
        x = rng.normal(size=(2, 9000))
        taps = rng.normal(size=31)
        from godsp_tpu.models import fir_filter, overlap_save

        got = np.asarray(overlap_save(x, taps, block=2048))
        ref = np.asarray(fir_filter(x, taps))
        assert snr_db(got, ref) >= 170.0

    def test_errors(self):
        from godsp_tpu.models import fftconvolve, overlap_save

        with pytest.raises(ValueError, match="unknown mode"):
            fftconvolve(np.ones(4), np.ones(4), mode="x")
        with pytest.raises(ValueError, match="empty"):
            fftconvolve(np.ones(0), np.ones(4))
        with pytest.raises(ValueError, match="empty taps"):
            overlap_save(np.ones(10), np.ones(0))


class TestMel:
    def test_filterbank_properties(self):
        from godsp_tpu.models import mel_filterbank

        fb = np.asarray(mel_filterbank(40, 1024, 16000.0))
        assert fb.shape == (40, 513)
        assert (fb >= 0).all()
        # unnormalized triangles peak at <= 1 (exactly 1 only when a bin
        # lands on the apex) and every filter is non-empty
        assert (fb.max(axis=1) <= 1.0 + 1e-6).all()
        assert (fb.max(axis=1) > 0).all()
        # centers are monotonically non-decreasing
        centers = fb.argmax(axis=1)
        assert (np.diff(centers) >= 0).all()

    def test_filterbank_slaney_norm(self):
        from godsp_tpu.models import mel_filterbank

        fb = np.asarray(mel_filterbank(20, 512, 8000.0, norm="slaney"))
        assert (fb.max(axis=1) < 1.0).all()  # area-normalized triangles

    def test_mel_spectrogram_is_filterbank_matmul(self):
        from godsp_tpu.models import mel_filterbank, mel_spectrogram, spectrogram

        x = _signal(4096).astype(np.float32)
        p = np.asarray(spectrogram(x, 512, 256))
        fb = np.asarray(mel_filterbank(32, 512, 8000.0))
        ref = p @ fb.T
        got = np.asarray(mel_spectrogram(x, 8000.0, nfft=512, hop=256, n_mels=32))
        np.testing.assert_allclose(got, ref, rtol=1e-5)

    def test_mfcc_shape_and_consistency(self):
        from godsp_tpu import fft as gfft
        from godsp_tpu.models import mel_spectrogram, mfcc

        x = _signal(8000).astype(np.float32)
        got = np.asarray(mfcc(x, 16000.0, n_mfcc=13, nfft=512, hop=256, n_mels=40))
        frames = (8000 - 512) // 256 + 1
        assert got.shape == (frames, 13)
        logmel = mel_spectrogram(
            x, 16000.0, nfft=512, hop=256, n_mels=40, norm="slaney", log=True
        )
        ref = np.asarray(gfft.dct(logmel, norm="ortho"))[:, :13]
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)

    def test_errors(self):
        from godsp_tpu.models import mel_filterbank, mfcc

        with pytest.raises(ValueError, match="fmax"):
            mel_filterbank(10, 256, 8000.0, fmin=5000.0, fmax=4000.0)
        with pytest.raises(ValueError, match="n_mfcc"):
            mfcc(np.zeros(4096, np.float32), 8000.0, n_mfcc=90, n_mels=80)


def test_hop_zero_raises():
    from godsp_tpu.models import istft, spectrogram, stft

    with pytest.raises(ValueError, match="hop must be positive"):
        stft(np.zeros(512, np.float32), 128, hop=0)
    with pytest.raises(ValueError, match="hop must be positive"):
        spectrogram(np.zeros(512, np.float32), 128, hop=0)
    with pytest.raises(ValueError, match="hop must be positive"):
        istft(np.zeros((4, 65), np.complex128), 128, hop=0)


class TestResample:
    @pytest.mark.parametrize(
        "n,num", [(100, 250), (256, 100), (128, 128), (64, 65), (101, 50), (100, 101)]
    )
    def test_vs_scipy(self, n, num):
        ss = pytest.importorskip("scipy.signal")
        rng = np.random.default_rng(n + num)
        x = rng.normal(size=(2, n))
        from godsp_tpu.models import resample

        got = np.asarray(resample(x, num))
        ref = ss.resample(x, num, axis=-1)
        assert got.shape == ref.shape
        assert snr_db(got, ref) >= 200.0

    def test_complex_and_errors(self):
        ss = pytest.importorskip("scipy.signal")
        rng = np.random.default_rng(1)
        x = rng.normal(size=64) + 1j * rng.normal(size=64)
        from godsp_tpu.models import resample

        got = np.asarray(resample(x, 48))
        assert snr_db(got, ss.resample(x, 48)) >= 200.0
        with pytest.raises(ValueError, match="num"):
            resample(np.ones(8), 0)


class TestGriffinLim:
    @staticmethod
    def _mag(x, nfft, hop):
        from godsp_tpu.models import stft

        return np.abs(np.asarray(stft(x, nfft, hop=hop)))

    @staticmethod
    def _signal(n=4096):
        t = np.arange(n) / n
        return np.sin(2 * np.pi * 200.3 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))

    def test_spectral_convergence(self):
        """Fast GLA drives the STFT-magnitude mismatch below 10% on a
        modulated tone, and momentum beats classic Griffin-Lim."""
        from godsp_tpu.models import griffin_lim

        x = self._signal()
        nfft, hop = 128, 32
        mag = self._mag(x, nfft, hop)
        y = np.asarray(griffin_lim(mag, nfft, hop=hop, n_iter=40))
        assert y.shape == ((mag.shape[0] - 1) * hop + nfft,)
        err = np.linalg.norm(self._mag(y, nfft, hop) - mag) / np.linalg.norm(mag)
        assert err < 0.10
        y0 = np.asarray(griffin_lim(mag, nfft, hop=hop, n_iter=40, momentum=0.0))
        err0 = np.linalg.norm(self._mag(y0, nfft, hop) - mag) / np.linalg.norm(mag)
        assert err < err0  # momentum accelerates

    def test_batched_and_length(self):
        from godsp_tpu.models import griffin_lim

        rng = np.random.default_rng(90)
        mag = np.abs(rng.normal(size=(2, 3, 12, 65)))
        y = np.asarray(griffin_lim(mag, 128, hop=64, n_iter=2, length=900))
        assert y.shape == (2, 3, 900)  # padded past the 11*64+128 span
        y2 = np.asarray(griffin_lim(mag, 128, hop=64, n_iter=2, length=500))
        assert y2.shape == (2, 3, 500)

    def test_n_iter_zero_is_zero_phase_istft(self):
        """n_iter=0 must equal a plain zero-phase inverse."""
        from godsp_tpu.models import griffin_lim, istft

        x = self._signal(2048)
        mag = self._mag(x, 128, 64)
        y = np.asarray(griffin_lim(mag, 128, hop=64, n_iter=0))
        ref = np.asarray(istft(mag.astype(np.complex128), 128, hop=64))
        assert snr_db(y, ref) >= 200.0

    def test_errors(self):
        from godsp_tpu.models import griffin_lim

        mag = np.ones((4, 65))
        with pytest.raises(ValueError, match="hop"):
            griffin_lim(mag, 128, hop=0)
        with pytest.raises(ValueError, match="inconsistent"):
            griffin_lim(np.ones((4, 60)), 128)
        with pytest.raises(ValueError, match="momentum"):
            griffin_lim(mag, 128, momentum=1.0)
        with pytest.raises(ValueError, match="n_iter"):
            griffin_lim(mag, 128, n_iter=-1)
        with pytest.raises(ValueError, match="frames"):
            griffin_lim(np.ones((0, 65)), 128)
        with pytest.raises(ValueError, match="pad must be >="):
            griffin_lim(mag, 128, pad=64)


class TestStreamingISTFT:
    """Chunked synthesis: concatenated blocks + coda == one-shot istft."""

    @staticmethod
    def _spec(L, nfft, hop, seed=0, batch=()):
        from godsp_tpu.models import stft

        rng = np.random.default_rng(seed)
        x = rng.normal(size=batch + (L,))
        return stft(x, nfft, hop=hop), x

    def _assert_stream_equal(self, s, nfft, hop, splits, **kw):
        from godsp_tpu.models import istft, stream_istft

        chunks = [s[..., a:b, :] for a, b in zip([0] + splits, splits + [s.shape[-2]])]
        got = np.concatenate(
            [np.asarray(b) for b in stream_istft(chunks, nfft, hop=hop, **kw)],
            axis=-1,
        )
        ref = np.asarray(istft(s, nfft, hop=hop, **kw))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)

    def test_equal_chunks(self):
        nfft, hop = 256, 128
        s, _ = self._spec(128 * 40 + 256, nfft, hop)
        self._assert_stream_equal(s, nfft, hop, [10, 20, 30])

    def test_ragged_chunks_75_overlap(self):
        nfft, hop = 256, 64  # H = 192: spill spans 3 hops
        s, _ = self._spec(64 * 60 + 256, nfft, hop)
        # ragged: 7, 13, 24, remainder (all satisfy F*hop >= 192)
        self._assert_stream_equal(s, nfft, hop, [7, 20, 44], window="hamming")

    def test_hop_eq_nfft_no_carry(self):
        nfft = hop = 128
        s, _ = self._spec(128 * 30, nfft, hop)
        self._assert_stream_equal(s, nfft, hop, [10])

    def test_batched(self):
        nfft, hop = 128, 64
        s, _ = self._spec(64 * 32 + 128, nfft, hop, batch=(3,))
        self._assert_stream_equal(s, nfft, hop, [16])

    def test_push_api_and_errors(self):
        from godsp_tpu.models import StreamingISTFT

        st = StreamingISTFT(256, 128)
        with pytest.raises(ValueError, match="chunk must be"):
            st.push(np.ones((4, 100), np.complex128))
        with pytest.raises(ValueError, match="too short"):
            st.push(np.ones((0, 129), np.complex128))
        st.push(np.ones((4, 129), np.complex128))
        st.flush()
        with pytest.raises(RuntimeError, match="after flush"):
            st.push(np.ones((4, 129), np.complex128))
        with pytest.raises(RuntimeError, match="twice"):
            st.flush()
        with pytest.raises(ValueError, match="hop <= nfft"):
            StreamingISTFT(256, 512)

class TestStreamingSTFT:
    """Chunked analysis: concatenated spectra blocks == one-shot stft."""

    def _assert_stream_equal(self, L, nfft, hop, splits, batch=(), **kw):
        from godsp_tpu.models import stft, stream_stft

        rng = np.random.default_rng(7)
        x = rng.normal(size=batch + (L,))
        chunks = [x[..., a:b] for a, b in zip([0] + splits, splits + [L])]
        blocks = list(stream_stft(chunks, nfft, hop=hop, **kw))
        got = np.concatenate([np.asarray(b) for b in blocks], axis=-2)
        ref = np.asarray(stft(x, nfft, hop=hop, **kw))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)

    def test_aligned_blocks_exact(self):
        # Block lengths a multiple of hop: stable carry, exact equality.
        self._assert_stream_equal(128 * 64 + 128, 256, 128, [128 * 16, 128 * 40])

    def test_ragged_blocks_and_short_first(self):
        # First block shorter than nfft (no frames yet), ragged rest.
        self._assert_stream_equal(10000, 256, 128, [100, 777, 5000])

    def test_odd_hop_and_pad(self):
        # hop=100 exercises the odd-hop framing; pad > nfft the zero-
        # extension path.
        self._assert_stream_equal(9000, 256, 100, [2048, 5000], pad=512)

    def test_batched_channels(self):
        self._assert_stream_equal(6000, 128, 64, [2000], batch=(2,))

    def test_twosided(self):
        self._assert_stream_equal(4000, 128, 64, [1500], onesided=False)

    def test_update_api_and_leftover(self):
        from godsp_tpu.models import StreamingSTFT

        st = StreamingSTFT(256, 128)
        assert st.update(np.zeros(100)) is None  # < nfft buffered
        assert st.leftover == 100
        spec = st.update(np.zeros(300))  # 400 total -> 2 frames
        assert spec.shape[-2] == 2 and spec.shape[-1] == 129
        assert st.leftover == 400 - 2 * 128
        with pytest.raises(ValueError, match="hop must be positive"):
            StreamingSTFT(256, 0)
        with pytest.raises(ValueError, match="pad must be >= nfft"):
            StreamingSTFT(256, 128, pad=128)

    def test_stream_mel_matches_one_shot(self):
        from godsp_tpu.models import mel_spectrogram, stream_mel

        rng = np.random.default_rng(8)
        L, nfft, hop = 12000, 512, 256
        x = rng.normal(size=L).astype(np.float32)
        blocks = list(
            stream_mel(
                [x[:4096], x[4096:8192], x[8192:]], 16000.0, nfft, hop,
                n_mels=40, log=True,
            )
        )
        got = np.concatenate([np.asarray(b) for b in blocks], axis=-2)
        ref = np.asarray(
            mel_spectrogram(x, 16000.0, nfft, hop, n_mels=40, log=True)
        )
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


class TestIIR:
    """models/iir.py: blocked parallel-scan IIR vs scipy.signal float64."""

    @staticmethod
    def _butter(order=4, wn=0.2, **kw):
        import scipy.signal as ss

        return ss.butter(order, wn, **kw)

    def test_lfilter_vs_scipy(self):
        import scipy.signal as ss

        from godsp_tpu.models import lfilter

        rng = np.random.default_rng(0)
        x = rng.normal(size=5000)
        b, a = self._butter()
        np.testing.assert_allclose(
            np.asarray(lfilter(b, a, x)), ss.lfilter(b, a, x),
            rtol=1e-10, atol=1e-12,
        )

    @pytest.mark.parametrize("block", [None, 32, 257])
    def test_block_size_invariance(self, block):
        import scipy.signal as ss

        from godsp_tpu.models import lfilter

        rng = np.random.default_rng(1)
        x = rng.normal(size=1111)
        b, a = self._butter(6, 0.3)
        np.testing.assert_allclose(
            np.asarray(lfilter(b, a, x, block_size=block)),
            ss.lfilter(b, a, x), rtol=1e-9, atol=1e-12,
        )

    def test_zi_streaming_continuity(self):
        import scipy.signal as ss

        from godsp_tpu.models import lfilter, lfilter_zi

        rng = np.random.default_rng(2)
        x = rng.normal(size=4096)
        b, a = self._butter()
        zi = np.asarray(lfilter_zi(b, a))
        np.testing.assert_allclose(zi, ss.lfilter_zi(b, a), rtol=1e-12)
        y1, zf = lfilter(b, a, x[:1500], zi=zi * x[0])
        y2, zf2 = lfilter(b, a, x[1500:], zi=zf)
        got = np.concatenate([np.asarray(y1), np.asarray(y2)])
        ref, zfr = ss.lfilter(b, a, x, zi=ss.lfilter_zi(b, a) * x[0])
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(zf2), zfr, rtol=1e-9, atol=1e-12)

    def test_batched_axis_complex(self):
        import scipy.signal as ss

        from godsp_tpu.models import lfilter

        rng = np.random.default_rng(3)
        b, a = self._butter(3, 0.4)
        xb = rng.normal(size=(3, 4, 777))
        np.testing.assert_allclose(
            np.asarray(lfilter(b, a, xb)), ss.lfilter(b, a, xb, axis=-1),
            rtol=1e-9, atol=1e-12,
        )
        x0 = rng.normal(size=(400, 5))
        np.testing.assert_allclose(
            np.asarray(lfilter(b, a, x0, axis=0)),
            ss.lfilter(b, a, x0, axis=0), rtol=1e-9, atol=1e-12,
        )
        xc = rng.normal(size=500) + 1j * rng.normal(size=500)
        np.testing.assert_allclose(
            np.asarray(lfilter(b, a, xc)), ss.lfilter(b, a, xc),
            rtol=1e-9, atol=1e-12,
        )

    def test_fir_and_pure_gain(self):
        import scipy.signal as ss

        from godsp_tpu.models import lfilter

        rng = np.random.default_rng(4)
        x = rng.normal(size=300)
        taps = np.hanning(9)
        np.testing.assert_allclose(
            np.asarray(lfilter(taps, [1.0], x)), ss.lfilter(taps, [1.0], x),
            rtol=1e-10, atol=1e-14,
        )
        y, zf = lfilter([2.5], [1.0], x, zi=np.zeros((0,)))
        np.testing.assert_allclose(np.asarray(y), 2.5 * x, rtol=1e-12)
        assert zf.shape == (0,)

    def test_sosfilt_vs_scipy(self):
        import scipy.signal as ss

        from godsp_tpu.models import sosfilt

        rng = np.random.default_rng(5)
        x = rng.normal(size=3000)
        sos = ss.butter(8, [0.1, 0.3], btype="band", output="sos")
        np.testing.assert_allclose(
            np.asarray(sosfilt(sos, x)), ss.sosfilt(sos, x),
            rtol=1e-9, atol=1e-12,
        )
        zi = ss.sosfilt_zi(sos) * x[0]
        got, gzf = sosfilt(sos, x, zi=zi)
        ref, rzf = ss.sosfilt(sos, x, zi=zi)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(gzf), rzf, rtol=1e-9, atol=1e-12)

    def test_filtfilt_vs_scipy(self):
        import scipy.signal as ss

        from godsp_tpu.models import filtfilt

        rng = np.random.default_rng(6)
        x = rng.normal(size=2000)
        b, a = self._butter()
        np.testing.assert_allclose(
            np.asarray(filtfilt(b, a, x)), ss.filtfilt(b, a, x),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(filtfilt(b, a, x, padlen=50)),
            ss.filtfilt(b, a, x, padlen=50), rtol=1e-9, atol=1e-12,
        )

    def test_errors(self):
        from godsp_tpu.models import filtfilt, lfilter, sosfilt

        with pytest.raises(ValueError, match="nonzero"):
            lfilter([1.0], [0.0, 1.0], np.ones(8))
        with pytest.raises(ValueError, match="1-D"):
            lfilter(np.ones((2, 2)), [1.0], np.ones(8))
        with pytest.raises(ValueError, match="n_sections"):
            sosfilt(np.ones((3, 5)), np.ones(8))
        with pytest.raises(ValueError, match="padlen"):
            filtfilt([1.0, 0.5], [1.0, -0.3], np.ones(5))
        with pytest.raises(ValueError, match="at least one sample"):
            lfilter([1.0, 0.5], [1.0, -0.3], np.zeros((3, 0)))


class TestPolyphaseResample:
    """firwin/upfirdn/resample_poly vs scipy.signal float64."""

    def test_firwin_vs_scipy(self):
        import scipy.signal as ss

        from godsp_tpu.models import firwin

        cases = [
            dict(numtaps=31, cutoff=0.3, window=("kaiser", 5.0)),
            dict(numtaps=64, cutoff=0.25, window="hamming"),
            dict(numtaps=31, cutoff=0.4, window="hamming", pass_zero=False),
            dict(numtaps=32, cutoff=[0.2, 0.5], window="hamming",
                 pass_zero=False),
            dict(numtaps=33, cutoff=[0.2, 0.5], window="blackman"),
        ]
        for kw in cases:
            got = firwin(**kw)
            ref = ss.firwin(**kw)
            np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)

    def test_firwin_errors(self):
        from godsp_tpu.models import firwin

        with pytest.raises(ValueError, match="inside"):
            firwin(31, 1.5)
        with pytest.raises(ValueError, match="increasing"):
            firwin(31, [0.5, 0.2])
        with pytest.raises(ValueError, match="Nyquist"):
            firwin(30, 0.4, pass_zero=False)

    @pytest.mark.parametrize("up,down", [(1, 1), (3, 1), (1, 4), (3, 2), (7, 5)])
    def test_upfirdn_vs_scipy(self, up, down):
        import scipy.signal as ss

        from godsp_tpu.models import upfirdn

        rng = np.random.default_rng(0)
        x = rng.normal(size=777)
        h = ss.firwin(41, 0.3)
        got = np.asarray(upfirdn(h, x, up, down))
        ref = ss.upfirdn(h, x, up, down)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)

    @pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (3, 2), (160, 441), (5, 5)])
    def test_resample_poly_vs_scipy(self, up, down):
        import scipy.signal as ss

        from godsp_tpu.models import resample_poly

        rng = np.random.default_rng(1)
        x = rng.normal(size=1000)
        got = np.asarray(resample_poly(x, up, down))
        ref = ss.resample_poly(x, up, down)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)

    def test_batched_complex_and_explicit_window(self):
        import scipy.signal as ss

        from godsp_tpu.models import resample_poly

        rng = np.random.default_rng(2)
        xb = rng.normal(size=(2, 3, 500))
        np.testing.assert_allclose(
            np.asarray(resample_poly(xb, 3, 2)),
            ss.resample_poly(xb, 3, 2, axis=-1), rtol=1e-9, atol=1e-12,
        )
        xc = rng.normal(size=400) + 1j * rng.normal(size=400)
        np.testing.assert_allclose(
            np.asarray(resample_poly(xc, 2, 3)), ss.resample_poly(xc, 2, 3),
            rtol=1e-9, atol=1e-12,
        )
        h = ss.firwin(41, 0.3)
        np.testing.assert_allclose(
            np.asarray(resample_poly(xc.real, 3, 2, window=h)),
            ss.resample_poly(xc.real, 3, 2, window=h), rtol=1e-9, atol=1e-12,
        )

    def test_errors(self):
        from godsp_tpu.models import resample_poly, upfirdn

        with pytest.raises(ValueError, match=">= 1"):
            resample_poly(np.ones(10), 0, 2)
        with pytest.raises(ValueError, match="1-D"):
            upfirdn(np.ones((2, 2)), np.ones(10))
        with pytest.raises(ValueError, match="at least one"):
            resample_poly(np.zeros(0), 2, 1)


class TestResampleFullSurface:
    """resample's full scipy surface: window specs, axis, t, domain."""

    def test_windows_axis_t_domain(self):
        import scipy.signal as ss

        from godsp_tpu.models import resample

        rng = np.random.default_rng(0)
        x = rng.normal(size=100)
        for w in ("hann", ("kaiser", 5.0)):
            g = np.asarray(resample(x, 64, window=w))
            np.testing.assert_allclose(g, ss.resample(x, 64, window=w),
                                       rtol=1e-9, atol=1e-11)
        arrw = rng.uniform(0.5, 1.0, 100)
        np.testing.assert_allclose(np.asarray(resample(x, 64, window=arrw)),
                                   ss.resample(x, 64, window=arrw),
                                   rtol=1e-9, atol=1e-11)
        fn = lambda f: (np.abs(f) < 0.3).astype(float)
        np.testing.assert_allclose(np.asarray(resample(x, 64, window=fn)),
                                   ss.resample(x, 64, window=fn),
                                   rtol=1e-9, atol=1e-11)
        X2 = rng.normal(size=(5, 100)).T
        np.testing.assert_allclose(np.asarray(resample(X2, 64, axis=0)),
                                   ss.resample(X2, 64, axis=0),
                                   rtol=1e-9, atol=1e-11)
        t = np.arange(100) * 0.01
        g, gt = resample(x, 64, t=t)
        r, rt = ss.resample(x, 64, t=t)
        np.testing.assert_allclose(np.asarray(g), r, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(gt, rt, rtol=1e-12, atol=0)
        Xf = np.fft.fft(x)
        np.testing.assert_allclose(np.asarray(resample(Xf, 64, domain="freq")),
                                   ss.resample(Xf, 64, domain="freq"),
                                   rtol=1e-9, atol=1e-11)
        with pytest.raises(ValueError):
            resample(x, 64, domain="bogus")


class TestFftconvolveAxes:
    """fftconvolve's scipy-style N-D `axes` parameter (the default stays
    the framework's batched trailing-axis convention)."""

    def test_nd_parity(self):
        import scipy.signal as ss

        from godsp_tpu.models import fftconvolve

        rng = np.random.default_rng(0)
        a = rng.normal(size=(10, 12, 7))
        b = rng.normal(size=(4, 5, 7))
        for mode in ("full", "same"):
            g = np.asarray(fftconvolve(a, b, mode, axes=(0, 1)))
            r = ss.fftconvolve(a, b, mode, axes=(0, 1))
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)
        a2 = rng.normal(size=(6, 8))
        b2 = rng.normal(size=(3, 4))
        for mode in ("full", "same", "valid"):
            g = np.asarray(fftconvolve(a2, b2, mode, axes=(0, 1)))
            r = ss.fftconvolve(a2, b2, mode, axes=(0, 1))
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)

    def test_single_axis_and_complex(self):
        import scipy.signal as ss

        from godsp_tpu.models import fftconvolve

        rng = np.random.default_rng(1)
        a = rng.normal(size=(5, 40)) + 1j * rng.normal(size=(5, 40))
        b = rng.normal(size=(5, 9))
        g = np.asarray(fftconvolve(a, b, "same", axes=-1))
        r = ss.fftconvolve(a, b, "same", axes=-1)
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)

    def test_validation(self):
        from godsp_tpu.models import fftconvolve

        with pytest.raises(ValueError):
            fftconvolve(np.zeros((4, 4)), np.ones((6, 2)), "valid",
                        axes=(0, 1))
        with pytest.raises(ValueError):
            fftconvolve(np.zeros((4, 4)), np.ones((2, 2)), axes=(0, 0))


class TestCorrelateAxes:
    def test_nd_parity(self):
        import scipy.signal as ss

        from godsp_tpu.models import correlate

        rng = np.random.default_rng(0)
        a = rng.normal(size=(9, 11))
        b = rng.normal(size=(4, 5))
        for mode in ("full", "same"):
            g = np.asarray(correlate(a, b, mode, axes=(0, 1)))
            r = ss.correlate(a, b, mode, method="fft")
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)
        ac = a + 1j * rng.normal(size=a.shape)
        g = np.asarray(correlate(ac, b, "full", axes=(0, 1)))
        r = ss.correlate(ac, b, "full", method="fft")
        np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)


class TestAxisParams:
    """scipy's axis/N parameters on hilbert, upfirdn, decimate."""

    def test_hilbert_N_axis(self):
        import scipy.signal as ss

        from godsp_tpu.fft import hilbert

        rng = np.random.default_rng(0)
        x = rng.normal(size=100)
        for N in (None, 128, 60):
            g = np.asarray(hilbert(x, N))
            r = ss.hilbert(x, N)
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=1e-11)
        X2 = rng.normal(size=(100, 3))
        np.testing.assert_allclose(np.asarray(hilbert(X2, axis=0)),
                                   ss.hilbert(X2, axis=0),
                                   rtol=1e-9, atol=1e-11)

    def test_upfirdn_decimate_axis(self):
        import scipy.signal as ss

        from godsp_tpu.models import decimate, upfirdn

        rng = np.random.default_rng(1)
        X2 = rng.normal(size=(100, 3))
        h = ss.firwin(31, 0.4)
        np.testing.assert_allclose(np.asarray(upfirdn(h, X2, 3, 2, axis=0)),
                                   ss.upfirdn(h, X2, 3, 2, axis=0),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(decimate(X2, 4, axis=0)),
                                   ss.decimate(X2, 4, axis=0),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(decimate(X2, 4, ftype="fir", axis=0)),
            ss.decimate(X2, 4, ftype="fir", axis=0), rtol=1e-6, atol=1e-7)
