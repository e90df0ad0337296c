"""utils: profiling hooks, metrics, host transfer."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from godsp_tpu.utils import BenchResult, annotate, to_host, trace_to
from godsp_tpu.utils.metrics import device_peaks, fft_bytes, fft_flops, hbm_bandwidth_gbs


class TestProfiling:
    def test_trace_to_writes_files(self, tmp_path):
        d = str(tmp_path / "trace")
        with trace_to(d):
            with annotate("test-span"):
                jnp.sum(jnp.ones((64, 64))).block_until_ready()
        found = [
            os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
        ]
        assert found, "trace produced no files"

    def test_annotate_context(self):
        with annotate("span"):
            pass  # must be a usable context manager

    def test_sum_device_events(self):
        from types import SimpleNamespace as NS

        from godsp_tpu.utils.profiling import sum_device_events

        ev = lambda name, ns: NS(name=name, duration_ns=ns)
        planes = [
            NS(name="/host:CPU", lines=[NS(events=[ev("ncclWait", 9e9)])]),
            NS(name="/device:GPU:0", lines=[
                NS(events=[ev("ncclDevKernel_AllToAll", 2e6), ev("fusion.3", 5e6)]),
                NS(events=[ev("NCCLKernel_SendRecv", 1e6)]),
            ]),
            NS(name="/device:GPU:1", lines=[NS(events=[ev("fusion", 1e6)])]),
        ]
        got = sum_device_events(planes, ("nccl",))
        assert got == {"/device:GPU:0": 3.0, "/device:GPU:1": 0.0}

    def test_device_event_ms_reads_a_trace(self, tmp_path):
        from godsp_tpu.utils.profiling import device_event_ms

        d = str(tmp_path / "trace")
        with trace_to(d):
            jnp.sum(jnp.ones((64, 64))).block_until_ready()
        # A CPU trace has no device planes: nothing to sum, no error.
        assert device_event_ms(d, ("nccl",)) == {}


class TestMetrics:
    def test_bench_result(self):
        r = BenchResult(name="x", wall_s=0.5, flops=1e9, bytes_moved=2e9)
        assert r.gflops == pytest.approx(2.0)
        assert r.gbs == pytest.approx(4.0)
        assert "gflops" in r.json_line()

    def test_fft_models(self):
        assert fft_flops(1024, 2) == pytest.approx(2 * 5 * 1024 * 10)
        assert fft_bytes(1024, 2, 8) == 2 * 2 * 1024 * 8

    def test_hbm_table(self):
        # unknown device kind -> an error, never a fabricated peak
        class Fake:
            device_kind = "mystery9000"

        with pytest.raises(KeyError, match="mystery9000"):
            hbm_bandwidth_gbs(Fake())

    def test_h200_peaks(self):
        class H200:
            device_kind = "NVIDIA H200"

        peaks = device_peaks(H200())
        assert peaks["hbm_gbs"] == 4800.0
        assert peaks["fp32_tflops"] == 67.0
        assert peaks["tf32_tflops"] == 495.0
        assert peaks["bf16_tflops"] == 989.0
        assert hbm_bandwidth_gbs(H200()) == 4800.0

    def test_roofline_fraction_explicit_peak(self):
        r = BenchResult(name="x", wall_s=1.0, bytes_moved=2.4e12)
        assert r.roofline_fraction(4800.0) == pytest.approx(0.5)

    def test_roofline_fraction_unknown_device_raises(self):
        # The CPU is not in the peak table: no fabricated fraction.
        r = BenchResult(name="x", wall_s=1.0, bytes_moved=1e9)
        with pytest.raises(KeyError, match="no published peaks"):
            r.roofline_fraction()

    @pytest.mark.parametrize("floor", ["copy", "matmul"])
    def test_floors_tiny(self, floor):
        from godsp_tpu.utils.metrics import copy_floor, matmul_floor

        if floor == "copy":
            r = copy_floor(1 << 16, iters=2)
            assert r.bytes_moved == 2 * (1 << 16) and r.wall_s > 0
        else:
            r = matmul_floor(64, iters=2)
            assert r.flops == 2 * 64**3 and r.wall_s > 0


class TestCompileCache:
    def test_env_var_honoured(self, monkeypatch, tmp_path):
        from godsp_tpu.utils import compile_cache_dir

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache_dir() == str(tmp_path)

    def test_fixed_path_in_checkout(self, monkeypatch):
        import pathlib

        import godsp_tpu
        from godsp_tpu.utils import compile_cache_dir

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = pathlib.Path(godsp_tpu.__file__).resolve().parent.parent
        assert compile_cache_dir() == str(root / ".jax_cache")
        assert compile_cache_dir() == compile_cache_dir()  # no pid/time

    def test_enable_sets_fixed_path(self, monkeypatch):
        import jax

        from godsp_tpu.utils import compile_cache_dir, enable_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
        path = enable_compile_cache()
        assert path == compile_cache_dir()
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_enable_sets_nothing_under_env(self, monkeypatch, tmp_path):
        import jax

        from godsp_tpu.utils import enable_compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = []
        monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
        assert enable_compile_cache() == str(tmp_path)
        assert calls == []


class TestToHost:
    def test_passthrough_and_complex(self):
        a = np.ones(4)
        assert to_host(a) is a
        c = to_host(jnp.asarray([1.0 + 2.0j], dtype=jnp.complex128))
        assert c.dtype == np.complex128 and c[0] == 1 + 2j

    @pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float32])
    def test_put_round_trip_bit_exact(self, dtype):
        from godsp_tpu._dtypes import put

        rng = np.random.default_rng(0)
        x = rng.normal(size=(8, 16)).astype(dtype)
        if np.dtype(dtype).kind == "c":
            x = x + 1j * rng.normal(size=(8, 16)).astype(dtype)
        d = put(x)
        assert put(d) is d  # device arrays pass through
        back = to_host(d)
        assert back.dtype == x.dtype and np.array_equal(back, x)
