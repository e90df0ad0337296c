"""FFT tests; golden tables ported from reference fft/fft_test.go, plus
round-trips and numpy.fft cross-validation (an oracle the reference
never had — SURVEY.md §4)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu import dsputils, fft

SQRT2_2 = math.sqrt(2) / 2

# fft_test.go:38-141
FFT_TESTS = [
    # impulse responses
    ([1], [1]),
    ([1, 0], [1, 1]),
    ([1, 0, 0, 0], [1, 1, 1, 1]),
    ([1, 0, 0, 0, 0, 0, 0, 0], [1] * 8),
    # shifted impulse responses
    ([0, 1], [1, -1]),
    ([0, 1, 0, 0], [1, -1j, -1, 1j]),
    (
        [0, 1, 0, 0, 0, 0, 0, 0],
        [
            1,
            complex(SQRT2_2, -SQRT2_2),
            -1j,
            complex(-SQRT2_2, -SQRT2_2),
            -1,
            complex(-SQRT2_2, SQRT2_2),
            1j,
            complex(SQRT2_2, SQRT2_2),
        ],
    ),
    # other
    ([1, 2, 3, 4], [10, complex(-2, 2), -2, complex(-2, -2)]),
    ([1, 3, 5, 7], [16, complex(-4, 4), -4, complex(-4, -4)]),
    (
        [1, 2, 3, 4, 5, 6, 7, 8],
        [
            36,
            complex(-4, 9.65685425),
            complex(-4, 4),
            complex(-4, 1.65685425),
            -4,
            complex(-4, -1.65685425),
            complex(-4, -4),
            complex(-4, -9.65685425),
        ],
    ),
    # non power of 2 lengths (Bluestein path)
    ([1, 0, 0, 0, 0], [1, 1, 1, 1, 1]),
    ([1, 2, 3], [6, complex(-1.5, 0.8660254), complex(-1.5, -0.8660254)]),
    ([1, 1, 1], [3, 0, 0]),
]

# fft_test.go:148-162
FFT2_TESTS = [
    (
        [[1, 2, 3], [3, 4, 5]],
        [
            [18, complex(-3, 1.73205081), complex(-3, -1.73205081)],
            [-6, 0, 0],
        ],
    ),
    (
        [[0.1, 0.2, 0.3, 0.4, 0.5], [1, 2, 3, 4, 5], [3, 2, 1, 0, -1]],
        [
            [
                21.5,
                complex(-0.25, 0.34409548),
                complex(-0.25, 0.08122992),
                complex(-0.25, -0.08122992),
                complex(-0.25, -0.34409548),
            ],
            [
                complex(-8.5, -8.66025404),
                complex(5.70990854, 4.6742225),
                complex(1.15694356, 4.41135694),
                complex(-1.65694356, 4.24889709),
                complex(-6.20990854, 3.98603154),
            ],
            [
                complex(-8.5, 8.66025404),
                complex(-6.20990854, -3.98603154),
                complex(-1.65694356, -4.24889709),
                complex(1.15694356, -4.41135694),
                complex(5.70990854, -4.6742225),
            ],
        ],
    ),
]

# fft_test.go:170-181
FFTN_TEST = {
    "in": [4, 2, 3, 8, 5, 6, 7, 2, 13, 24, 13, 17],
    "dim": [2, 2, 3],
    "out": [
        104,
        complex(12.5, 14.72243186),
        complex(12.5, -14.72243186),
        -42,
        complex(-10.5, 6.06217783),
        complex(-10.5, -6.06217783),
        -48,
        complex(-4.5, -11.25833025),
        complex(-4.5, 11.25833025),
        22,
        complex(8.5, -6.06217783),
        complex(8.5, 6.06217783),
    ],
}


@pytest.mark.parametrize("x,expected", FFT_TESTS, ids=lambda v: str(v)[:24])
def test_fft_golden(x, expected):
    got = np.asarray(fft.fft_real(jnp.asarray(x, dtype=jnp.float64)))
    assert dsputils.pretty_close_c(got, np.asarray(expected, np.complex128)), got


@pytest.mark.parametrize("x,expected", FFT_TESTS, ids=lambda v: str(v)[:24])
def test_ifft_roundtrip_golden(x, expected):
    back = np.asarray(fft.ifft(jnp.asarray(expected, dtype=jnp.complex128)))
    assert dsputils.pretty_close_c(back, np.asarray(x, np.complex128)), back


def test_fft_empty_and_single():
    assert fft.fft(jnp.zeros(0, jnp.complex128)).shape == (0,)
    np.testing.assert_allclose(np.asarray(fft.fft(jnp.array([3.0 + 1j]))), [3 + 1j])
    np.testing.assert_allclose(np.asarray(fft.ifft(jnp.array([3.0 + 1j]))), [3 + 1j])


@pytest.mark.parametrize("x,expected", FFT2_TESTS, ids=["2x3", "3x5"])
def test_fft2_golden(x, expected):
    got = np.asarray(fft.fft2_real(x))
    assert dsputils.pretty_close_2(got, np.asarray(expected, np.complex128)), got
    back = np.asarray(fft.ifft2(jnp.asarray(expected, dtype=jnp.complex128)))
    assert dsputils.pretty_close_2(back, np.asarray(x, np.complex128))


def test_fft2_errors():
    with pytest.raises(ValueError, match="empty"):
        fft.fft2([])
    with pytest.raises(ValueError, match="ragged"):
        fft.fft2([[1, 2], [3]])


def test_fftn_golden():
    m = dsputils.make_matrix(
        dsputils.to_complex(jnp.asarray(FFTN_TEST["in"], jnp.float64)), FFTN_TEST["dim"]
    )
    o = dsputils.make_matrix(np.asarray(FFTN_TEST["out"], np.complex128), FFTN_TEST["dim"])
    v = fft.fftn(m)
    assert v.pretty_close(o), np.asarray(v.array)
    vi = fft.ifftn(o)
    assert vi.pretty_close(m)


def test_fftn_on_plain_array():
    x = np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.complex128)
    got = np.asarray(fft.fftn(x))
    np.testing.assert_allclose(got, np.fft.fftn(x), rtol=1e-10, atol=1e-10)


def test_convolve():
    # Circular convolution of impulse with anything is identity.
    x = jnp.asarray(np.random.default_rng(1).normal(size=8), jnp.float64)
    e = jnp.zeros(8, jnp.float64).at[0].set(1.0)
    got = np.asarray(fft.convolve(x, e))
    np.testing.assert_allclose(got.real, np.asarray(x), atol=1e-10)
    np.testing.assert_allclose(got.imag, 0, atol=1e-10)


def test_convolve_unequal_lengths():
    with pytest.raises(ValueError, match="equal size"):
        fft.convolve(jnp.zeros(4), jnp.zeros(8))


@pytest.mark.parametrize("n", [2, 4, 8, 64, 256, 1024, 3, 5, 6, 7, 12, 100, 1000, 1331])
def test_fft_vs_numpy(n):
    """Cross-validate against numpy.fft at >=120 dB SNR (BASELINE bound)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    got = np.asarray(fft.fft(jnp.asarray(x)))
    want = np.fft.fft(x)
    assert dsputils.snr_db(got, want) >= 120.0
    back = np.asarray(fft.ifft(jnp.asarray(want)))
    assert dsputils.snr_db(back, x) >= 120.0


@pytest.mark.parametrize("n", [8, 1024, 1000])
def test_fft_batched_matches_loop(n):
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(5, n)) + 1j * rng.normal(size=(5, n))
    batched = np.asarray(fft.fft(jnp.asarray(xs)))
    for i in range(5):
        single = np.asarray(fft.fft(jnp.asarray(xs[i])))
        np.testing.assert_allclose(batched[i], single, rtol=1e-12, atol=1e-12)


def test_fft_axis_argument():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6)) + 1j * rng.normal(size=(4, 6))
    got = np.asarray(fft.fft(jnp.asarray(x), axis=0))
    np.testing.assert_allclose(got, np.fft.fft(x, axis=0), rtol=1e-10, atol=1e-10)


def test_lyons_example():
    """ExampleFFTReal (fft_test.go:283-320): Lyons §3.1.1 two-tone."""
    n = np.arange(8)
    a = np.sin(2 * np.pi * n / 8) + 0.5 * np.sin(2 * np.pi * n / 4 + 3 * np.pi / 4)
    X = np.asarray(fft.fft_real(jnp.asarray(a)))
    mag = np.abs(X)
    phase_deg = np.degrees(np.angle(X))
    np.testing.assert_allclose(mag, [0, 4, 2, 0, 0, 0, 2, 4], atol=1e-8)
    assert abs(phase_deg[1] - (-90)) < 1e-6
    assert abs(phase_deg[2] - 45) < 1e-6
    assert abs(phase_deg[6] - (-45)) < 1e-6
    assert abs(phase_deg[7] - 90) < 1e-6


def test_ensure_radix2_factors():
    fft.ensure_radix2_factors(1 << 12)  # smoke: pre-warms the twiddle cache


from godsp_tpu.dsputils import snr_db


class TestPropertyRoundTrips:
    """Property-style coverage across arbitrary lengths (Bluestein tail)
    and axes — beyond the reference's fixed golden sizes."""

    @pytest.mark.parametrize("n", [2, 3, 7, 12, 31, 60, 100, 127, 255, 257, 500])
    def test_roundtrip_arbitrary_n(self, n):
        rng = np.random.default_rng(n)
        x = rng.normal(size=n) + 1j * rng.normal(size=n)
        back = np.asarray(fft.ifft(fft.fft(x)))
        assert snr_db(back, x) >= 200.0

    @pytest.mark.parametrize("n", [3, 5, 17, 100, 1000])
    def test_forward_vs_numpy_arbitrary_n(self, n):
        rng = np.random.default_rng(n + 1)
        x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
        got = np.asarray(fft.fft(x))
        assert snr_db(got, np.fft.fft(x)) >= 200.0

    def test_axis_argument(self):
        rng = np.random.default_rng(42)
        x = rng.normal(size=(8, 5, 16)) + 1j * rng.normal(size=(8, 5, 16))
        for ax in (0, 1, 2, -1):
            got = np.asarray(fft.fft(x, axis=ax))
            assert snr_db(got, np.fft.fft(x, axis=ax)) >= 200.0
            back = np.asarray(fft.ifft(fft.fft(x, axis=ax), axis=ax))
            assert snr_db(back, x) >= 200.0

    def test_parseval(self):
        rng = np.random.default_rng(7)
        x = rng.normal(size=777)
        X = np.asarray(fft.fft_real(x))
        assert np.isclose(np.sum(np.abs(X) ** 2) / 777, np.sum(x**2), rtol=1e-10)

    def test_convolve_vs_direct(self):
        rng = np.random.default_rng(9)
        n = 48
        a = rng.normal(size=n)
        b = rng.normal(size=n)
        got = np.asarray(fft.convolve(a, b))
        direct = np.array(
            [sum(a[j] * b[(k - j) % n] for j in range(n)) for k in range(n)]
        )
        assert snr_db(got.real, direct) >= 180.0


def test_convolve_empty_equal_lengths():
    """len-0 equal inputs: FFT of len 0 is empty (fft.go:76-80), so the
    convolution is empty too — no panic path applies."""
    out = np.asarray(fft.convolve(np.zeros(0), np.zeros(0)))
    assert out.shape == (0,)


class TestDCT:
    """fft.dct/idct vs scipy.fft (types 2/3, both norms)."""

    @pytest.mark.parametrize("n", [4, 8, 100, 256, 1024])
    def test_dct2_vs_scipy(self, n):
        sfft = pytest.importorskip("scipy.fft")
        rng = np.random.default_rng(n)
        x = rng.normal(size=(3, n))
        assert snr_db(np.asarray(fft.dct(x)), sfft.dct(x, type=2)) >= 200.0
        assert (
            snr_db(np.asarray(fft.dct(x, norm="ortho")), sfft.dct(x, 2, norm="ortho"))
            >= 200.0
        )

    @pytest.mark.parametrize("n", [8, 100, 512])
    def test_idct_roundtrip(self, n):
        sfft = pytest.importorskip("scipy.fft")
        rng = np.random.default_rng(n + 1)
        x = rng.normal(size=n)
        back = np.asarray(fft.idct(fft.dct(x, norm="ortho"), norm="ortho"))
        assert snr_db(back, x) >= 200.0
        got = np.asarray(fft.idct(sfft.dct(x, 2)))
        assert snr_db(got, sfft.idct(sfft.dct(x, 2))) >= 200.0

    def test_errors(self):
        with pytest.raises(ValueError, match="unknown norm"):
            fft.dct(np.ones(8), norm="x")
        with pytest.raises(ValueError, match="real input"):
            fft.dct(np.ones(8, dtype=np.complex128))


class TestFourStepLarge:
    """Large single transforms through the four-step recursion (the one
    power-of-2 route), float64 on the CPU against numpy."""

    @pytest.mark.parametrize("log2n", range(15, 22))
    def test_public_fft_vs_numpy(self, log2n):
        n = 1 << log2n
        rng = np.random.default_rng(n)
        x = rng.normal(size=n) + 1j * rng.normal(size=n)
        got = np.asarray(fft.fft(x))
        assert snr_db(got, np.fft.fft(x)) >= 200.0

    def test_inverse_round_trip_batched(self):
        n = 1 << 15
        rng = np.random.default_rng(7)
        x = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
        back = np.asarray(fft.ifft(fft.fft(x)))
        assert snr_db(back, x) >= 200.0

    def test_multi_tone_closed_form(self):
        """Integer-bin tones have an exact spectrum: the residual-form
        SNR (utils.oracles) needs no reference transform."""
        from godsp_tpu.utils.oracles import tone_signal, tone_snr_db

        n = 1 << 21
        tones = [(3, 0.5, 0.1), (12345, 0.25, -0.3), ((n >> 1) + 7, 0.125, 0.7)]
        got = np.asarray(fft.fft(tone_signal(n, tones)))
        assert tone_snr_db(got, tones) >= 200.0


class TestHelpers:
    """fft/helpers.py: frequency grids, shifts, analytic signal."""

    @pytest.mark.parametrize("n", [8, 9, 100, 1024])
    def test_fftfreq_vs_numpy(self, n):
        np.testing.assert_allclose(
            np.asarray(fft.fftfreq(n, 0.25)), np.fft.fftfreq(n, 0.25)
        )
        np.testing.assert_allclose(
            np.asarray(fft.rfftfreq(n, 0.25)), np.fft.rfftfreq(n, 0.25)
        )

    @pytest.mark.parametrize("n", [8, 9])
    def test_shift_roundtrip(self, n):
        x = np.arange(n, dtype=np.float64)
        np.testing.assert_array_equal(np.asarray(fft.fftshift(x)), np.fft.fftshift(x))
        np.testing.assert_array_equal(
            np.asarray(fft.ifftshift(fft.fftshift(x))), x
        )
        x2 = np.arange(n * 6, dtype=np.float64).reshape(n, 6)
        np.testing.assert_array_equal(
            np.asarray(fft.fftshift(x2)), np.fft.fftshift(x2)
        )
        np.testing.assert_array_equal(
            np.asarray(fft.fftshift(x2, axes=1)), np.fft.fftshift(x2, axes=1)
        )

    @pytest.mark.parametrize("n", [64, 100, 256])
    def test_hilbert_vs_scipy(self, n):
        import scipy.signal as ss

        rng = np.random.default_rng(n)
        x = rng.normal(size=n)
        got = np.asarray(fft.hilbert(jnp.asarray(x)))
        ref = ss.hilbert(x)
        assert snr_db(got, ref) >= 150.0

    def test_hilbert_envelope(self):
        """|hilbert| of a modulated tone recovers the envelope."""
        t = np.arange(4096) / 4096
        env = 1.0 + 0.5 * np.sin(2 * np.pi * 3 * t)
        x = env * np.cos(2 * np.pi * 200 * t)
        got = np.abs(np.asarray(fft.hilbert(jnp.asarray(x))))
        # ignore edges (Gibbs at the boundaries)
        sl = slice(200, -200)
        np.testing.assert_allclose(got[sl], env[sl], rtol=2e-2)


class TestSplitAPI:
    """fft/split.py: the planes-native public FFT."""

    @pytest.mark.parametrize("n", [8, 256, 1024, 1000])
    def test_matches_complex_api(self, n):
        rng = np.random.default_rng(n)
        xr = rng.normal(size=(3, n))
        xi = rng.normal(size=(3, n))
        yr, yi = fft.fft_split(jnp.asarray(xr), jnp.asarray(xi))
        ref = np.asarray(fft.fft(jnp.asarray(xr + 1j * xi)))
        got = np.asarray(yr) + 1j * np.asarray(yi)
        bound = 120.0 if n == 1000 else 200.0  # Bluestein fallback vs exact
        assert snr_db(got, ref) >= bound

    @pytest.mark.parametrize("n", [256, 1024, 1000])
    def test_inverse_roundtrip(self, n):
        rng = np.random.default_rng(n + 1)
        xr = rng.normal(size=n)
        xi = rng.normal(size=n)
        yr, yi = fft.fft_split(jnp.asarray(xr), jnp.asarray(xi))
        zr, zi = fft.ifft_split(yr, yi)
        got = np.asarray(zr) + 1j * np.asarray(zi)
        assert snr_db(got, xr + 1j * xi) >= 120.0

    def test_real_input(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=512)
        yr, yi = fft.fft_split(jnp.asarray(x))
        ref = np.fft.fft(x)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        assert snr_db(got, ref) >= 200.0

    def test_shape_errors(self):
        with pytest.raises(ValueError, match="identical shapes"):
            fft.fft_split(jnp.zeros(8), jnp.zeros(9))


class TestCZT:
    """Chirp-z / zoom FFT vs scipy.signal and the framework's own fft."""

    def test_default_is_dft(self):
        from godsp_tpu.fft import czt, fft

        rng = np.random.default_rng(0)
        for n in (16, 37, 100):
            x = rng.normal(size=n) + 1j * rng.normal(size=n)
            got = np.asarray(czt(x))
            ref = np.asarray(fft(x))
            assert snr_db(got, ref) >= 200.0

    @pytest.mark.parametrize(
        "n,m,wa",
        [
            (100, 60, None),  # default contour, m < n
            (37, 37, None),
            (64, 33, "mild_spiral"),
            (128, 65, "band"),
        ],
    )
    def test_vs_scipy(self, n, m, wa):
        ss = pytest.importorskip("scipy.signal")
        from godsp_tpu.fft import czt

        rng = np.random.default_rng(n)
        x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
        if wa == "mild_spiral":
            w, a = np.exp(-0.001 - 2j * np.pi / m), 1.1 + 0.1j
        elif wa == "band":
            w, a = np.exp(-2j * np.pi * 0.3 / m), np.exp(2j * np.pi * 0.05)
        else:
            w, a = None, 1 + 0j
        got = np.asarray(czt(x, m, w, a))
        ref = ss.czt(x, m, w, a)
        assert got.shape == ref.shape
        assert snr_db(got, ref) >= 200.0

    # scipy's own _czt.py trips numpy's array-to-scalar deprecation
    # internally (scipy bug, not ours) — keep the oracle, drop its noise.
    @pytest.mark.filterwarnings(
        "ignore:Conversion of an array with ndim > 0:DeprecationWarning"
    )
    @pytest.mark.parametrize(
        "n,fn,m,fs,ep",
        [
            (100, (0.1, 0.4), 50, 2.0, False),
            (77, 0.5, None, 2.0, False),
            (64, (100.0, 200.0), 40, 1000.0, True),
        ],
    )
    def test_zoom_vs_scipy(self, n, fn, m, fs, ep):
        ss = pytest.importorskip("scipy.signal")
        from godsp_tpu.fft import zoom_fft

        rng = np.random.default_rng(n)
        x = rng.normal(size=n)
        got = np.asarray(zoom_fft(x, fn, m, fs=fs, endpoint=ep))
        ref = ss.zoom_fft(x, np.atleast_1d(fn), m, fs=fs, endpoint=ep)
        assert snr_db(got, ref) >= 200.0

    def test_zoom_band_matches_fft_bins(self):
        """Zooming [0, fs/2] at m=n/2... picks exact FFT bins."""
        from godsp_tpu.fft import fft, zoom_fft

        rng = np.random.default_rng(9)
        n = 128
        x = rng.normal(size=n)
        # fs=n: frequencies are integer bins; [16, 48) at 32 points.
        got = np.asarray(zoom_fft(x, (16.0, 48.0), 32, fs=float(n)))
        ref = np.asarray(fft(x.astype(np.complex128)))[16:48]
        assert snr_db(got, ref) >= 200.0

    def test_errors(self):
        from godsp_tpu.fft import czt, zoom_fft

        with pytest.raises(ValueError, match="at least one"):
            czt(np.zeros(0, np.complex128))
        with pytest.raises(ValueError, match="m must be"):
            czt(np.ones(4, np.complex128), m=0)
        with pytest.raises(ValueError, match="nonzero"):
            czt(np.ones(4, np.complex128), w=0.0)
        with pytest.raises(ValueError, match="fn must be"):
            zoom_fft(np.ones(8), (0.1, 0.2, 0.3))
        with pytest.raises(ValueError, match="m must be"):
            zoom_fft(np.ones(8), 0.5, m=1, endpoint=True)


class TestTrigTransformFamily:
    """All eight real trig transforms (DCT/DST types 1-4) vs scipy.fft,
    both norms, plus exact round trips (fft/dct.py)."""

    SIZES = [2, 5, 8, 31, 128]

    @pytest.mark.parametrize("t", [1, 2, 3, 4])
    @pytest.mark.parametrize("norm", [None, "ortho"])
    def test_scipy_parity(self, t, norm):
        import scipy.fft as sfft

        rng = np.random.default_rng(t)
        for n in self.SIZES:
            x = rng.normal(size=n)
            for mine, ref in [(fft.dct, sfft.dct), (fft.dst, sfft.dst),
                              (fft.idct, sfft.idct), (fft.idst, sfft.idst)]:
                g = np.asarray(mine(x, type=t, norm=norm))
                r = ref(x, type=t, norm=norm)
                assert snr_db(g, r) >= 200.0, (mine.__name__, n, t, norm)

    @pytest.mark.parametrize("t", [1, 2, 3, 4])
    def test_round_trip(self, t):
        rng = np.random.default_rng(10 + t)
        x = rng.normal(size=24)
        for norm in (None, "ortho"):
            back = np.asarray(fft.idct(fft.dct(x, t, norm), t, norm))
            assert snr_db(back, x) >= 200.0
            back = np.asarray(fft.idst(fft.dst(x, t, norm), t, norm))
            assert snr_db(back, x) >= 200.0

    def test_batched(self):
        import scipy.fft as sfft

        xb = np.random.default_rng(20).normal(size=(3, 32))
        assert snr_db(np.asarray(fft.dst(xb, 4)), sfft.dst(xb, 4)) >= 200.0

    def test_validation(self):
        with pytest.raises(ValueError):
            fft.dct(np.ones(8), type=5)
        with pytest.raises(ValueError):
            fft.dst(np.ones(8), norm="bogus")
        with pytest.raises(ValueError):
            fft.dct(np.ones(1), type=1)  # DCT-I needs >= 2 points


class TestCztClasses:
    """CZT / ZoomFFT callable plans (scipy.signal class surface)."""

    def test_czt_plan(self):
        import scipy.signal as sps

        rng = np.random.default_rng(0)
        x = rng.normal(size=96) + 1j * rng.normal(size=96)
        plan = fft.CZT(96, m=64, w=np.exp(-2j * np.pi / 80), a=np.exp(0.3j))
        ref = sps.CZT(96, m=64, w=np.exp(-2j * np.pi / 80), a=np.exp(0.3j))
        assert snr_db(np.asarray(plan(x)), ref(x)) >= 180.0
        np.testing.assert_allclose(plan.points(), ref.points(),
                                   rtol=1e-12, atol=1e-13)
        # plan reuse on a second signal
        y = rng.normal(size=96)
        assert snr_db(np.asarray(plan(y)), ref(y)) >= 180.0
        with pytest.raises(ValueError):
            plan(np.zeros(50))

    def test_zoom_plan(self):
        import scipy.signal as sps

        rng = np.random.default_rng(1)
        x = rng.normal(size=96)
        plan = fft.ZoomFFT(96, [0.2, 0.6], m=48, fs=2.0)
        ref = sps.ZoomFFT(96, [0.2, 0.6], m=48, fs=2.0)
        assert snr_db(np.asarray(plan(x)), ref(x)) >= 180.0
        np.testing.assert_allclose(plan.points(), ref.points(),
                                   rtol=1e-12, atol=1e-13)
        with pytest.raises(ValueError):
            fft.ZoomFFT(96, [0.1, 0.2, 0.3])


class TestScipyFftNames:
    """scipy.fft-style surface: rfft/irfft/hfft/ihfft + the N-D
    dctn/idctn/dstn/idstn drivers."""

    def test_rfft_irfft(self):
        import scipy.fft as sfft

        x = np.random.default_rng(0).normal(size=50)
        for n in (None, 50, 30, 77, 64):
            g = np.asarray(fft.rfft(x, n))
            r = sfft.rfft(x, n)
            assert g.shape == r.shape
            assert snr_db(g, r) >= 180.0
        X = sfft.rfft(x)
        for n in (None, 50, 49, 30, 80):
            g = np.asarray(fft.irfft(X, n))
            r = sfft.irfft(X, n)
            assert g.shape == r.shape
            assert snr_db(g, r) >= 180.0
        X2 = np.random.default_rng(1).normal(size=(4, 50)).T
        g = np.asarray(fft.rfft(X2, axis=0))
        assert snr_db(g, sfft.rfft(X2, axis=0)) >= 180.0
        with pytest.raises(ValueError):
            fft.rfft(np.zeros(8) + 0j)

    def test_hfft_ihfft(self):
        import scipy.fft as sfft

        rng = np.random.default_rng(2)
        z = rng.normal(size=26) + 1j * rng.normal(size=26)
        for n in (None, 50, 49, 30):
            assert snr_db(np.asarray(fft.hfft(z, n)), sfft.hfft(z, n)) >= 170.0
        x = rng.normal(size=40)
        for n in (None, 40, 24):
            assert snr_db(np.asarray(fft.ihfft(x, n)),
                          sfft.ihfft(x, n)) >= 180.0

    @pytest.mark.parametrize("t", [1, 2, 3, 4])
    def test_dctn_family(self, t):
        import scipy.fft as sfft

        A = np.random.default_rng(3).normal(size=(8, 12, 5))
        for norm in (None, "ortho"):
            for axes in (None, (0, 2), 1):
                for mine, ref in [(fft.dctn, sfft.dctn), (fft.idctn, sfft.idctn),
                                  (fft.dstn, sfft.dstn), (fft.idstn, sfft.idstn)]:
                    g = np.asarray(mine(A, type=t, axes=axes, norm=norm))
                    assert snr_db(g, ref(A, type=t, axes=axes, norm=norm)) >= 200.0


class TestRfftnAndFastLen:
    def test_rfftn_irfftn(self):
        import scipy.fft as sfft

        x = np.random.default_rng(0).normal(size=(6, 10, 8))
        for axes in (None, (-2, -1), (0, 2)):
            g = np.asarray(fft.rfftn(x, axes=axes))
            r = sfft.rfftn(x, axes=axes)
            assert g.shape == r.shape
            assert snr_db(g, r) >= 180.0
            gi = np.asarray(fft.irfftn(g, axes=axes))
            assert snr_db(gi, sfft.irfftn(r, axes=axes)) >= 180.0
        g = np.asarray(fft.rfftn(x, s=(8, 12, 6)))
        assert snr_db(g, sfft.rfftn(x, s=(8, 12, 6))) >= 180.0
        g = np.asarray(fft.rfft2(x))
        assert snr_db(g, sfft.rfft2(x)) >= 180.0

    def test_fast_len(self):
        import scipy.fft as sfft

        for t in list(range(1, 700)) + [4099, 90001]:
            for real in (False, True):
                assert fft.next_fast_len(t, real) == sfft.next_fast_len(t, real)
                assert fft.prev_fast_len(t, real) == sfft.prev_fast_len(t, real)


class TestFftlog:
    """fht/ifht/fhtoffset (FFTLog fast Hankel transform) vs scipy.fft."""

    def test_scipy_parity(self):
        import scipy.fft as sfft

        r = np.logspace(-2, 2, 64)
        a = r * np.exp(-(r**2) / 2)
        dln = np.log(r[1] / r[0])
        for mu, off, q in [(0.5, 0.0, 0.0), (0.0, 0.2, 0.0),
                           (1.0, sfft.fhtoffset(dln, 1.0), 0.0),
                           (0.5, 0.1, 0.3), (2.0, 0.0, -0.2)]:
            g = np.asarray(fft.fht(a, dln, mu, offset=off, bias=q))
            ref = sfft.fht(a, dln, mu, offset=off, bias=q)
            assert snr_db(g, ref) >= 200.0
            gi = np.asarray(fft.ifht(ref, dln, mu, offset=off, bias=q))
            assert snr_db(gi, sfft.ifht(ref, dln, mu, offset=off,
                                        bias=q)) >= 200.0

    def test_fhtoffset(self):
        import scipy.fft as sfft

        for args in [(0.14387, 0.5), (0.14387, 0.5, -1.0, 0.2),
                     (0.05, 2.0, 0.3, 0.0)]:
            assert abs(fft.fhtoffset(*args) - sfft.fhtoffset(*args)) < 1e-12

    def test_round_trip_odd_batched(self):
        r = np.logspace(-1, 1, 65)
        a = np.stack([r * np.exp(-r), r**2 * np.exp(-r)])
        dln = np.log(r[1] / r[0])
        A = fft.fht(a, dln, 0.5, offset=fft.fhtoffset(dln, 0.5))
        back = np.asarray(fft.ifht(A, dln, 0.5,
                                   offset=fft.fhtoffset(dln, 0.5)))
        assert snr_db(back, a) >= 180.0


def test_dctn_duplicate_axes_raise():
    with pytest.raises(ValueError):
        fft.dctn(np.zeros((4, 4)), axes=(0, 0))


def test_hermitian_nd_transforms():
    import scipy.fft as sfft

    rng = np.random.default_rng(4)
    z = rng.normal(size=(6, 5)) + 1j * rng.normal(size=(6, 5))
    for mine, ref in [(fft.hfftn, sfft.hfftn), (fft.hfft2, sfft.hfft2)]:
        g = np.asarray(mine(z))
        r = ref(z)
        assert g.shape == r.shape
        assert snr_db(g, r) >= 170.0
    x = rng.normal(size=(6, 8))
    for mine, ref in [(fft.ihfftn, sfft.ihfftn), (fft.ihfft2, sfft.ihfft2)]:
        assert snr_db(np.asarray(mine(x)), ref(x)) >= 180.0
    g = np.asarray(fft.hfftn(z, s=(8, 12)))
    assert snr_db(g, sfft.hfftn(z, s=(8, 12))) >= 170.0
