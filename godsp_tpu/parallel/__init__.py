"""Multi-device scaling: device meshes, sharded + streaming Welch PSD.

Replaces the reference's goroutine worker pool (SURVEY.md §2.2): data
parallelism over channels ("dp"), sequence parallelism over the time
axis ("sp") with a ppermute halo exchange, and psum periodogram
reduction.
"""

from godsp_tpu.parallel._fft_sharded_impl import fft_sharded
from godsp_tpu.parallel.mesh import MeshConfig, init_distributed, make_mesh
from godsp_tpu.parallel._pwelch_sharded_impl import (
    partial_periodogram,
    pwelch_sharded,
    sharded_partial_step,
)
from godsp_tpu.parallel.stft_sharded import istft_sharded, spectrogram_sharded
from godsp_tpu.parallel.streaming import StreamingPwelch, stream_pwelch, stream_welch

__all__ = [
    "MeshConfig",
    "fft_sharded",
    "StreamingPwelch",
    "make_mesh",
    "partial_periodogram",
    "init_distributed",
    "istft_sharded",
    "pwelch_sharded",
    "sharded_partial_step",
    "spectrogram_sharded",
    "stream_pwelch",
    "stream_welch",
]
