#!/usr/bin/env python
"""Distributed streaming Pwelch on a device mesh.

Runs on real chips when available; to demo multi-device semantics on a
CPU host:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/distributed_pwelch.py

Across several processes or hosts, call parallel.init_distributed() with
the coordinator address, process count and process id in every process
first; the identical code then shards over all devices.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), ".."))

from godsp_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np

from godsp_tpu import spectral
from godsp_tpu.parallel import MeshConfig, StreamingPwelch, make_mesh


def main():
    n_dev = len(jax.devices())
    sp = max(1, n_dev)
    mesh = make_mesh(MeshConfig(dp=1, sp=sp))
    print(f"mesh: dp=1 sp={sp} over {jax.devices()[0].platform}")

    fs = 44100.0
    opts = spectral.PwelchOptions(nfft=1024, noverlap=512)
    sp_drv = StreamingPwelch(
        fs, opts, mesh,
        segs_per_chunk_shard=64,
        checkpoint_path="/tmp/pwelch_demo.ckpt.npz",
        checkpoint_every_chunks=4,
    )

    rng = np.random.default_rng(0)
    t = 0
    for _ in range(40):  # ~40 blocks of 100k samples
        n = 100_000
        tt = (np.arange(n) + t) / fs
        block = np.sin(2 * np.pi * 5000 * tt) + 0.1 * rng.normal(size=n)
        sp_drv.update(block)
        t += n

    pxx, freqs = sp_drv.finalize()
    print("peak at", freqs[int(np.argmax(pxx[1:])) + 1], "Hz")
    print("metrics:", sp_drv.metrics.json_line())


if __name__ == "__main__":
    main()
