#!/usr/bin/env python
"""Regenerate docs/API.md from the public `__all__` surface.

One line per exported symbol with the first docstring line; run from the
repo root after adding/removing public API:  python docs/gen_api.py
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

MODULES = [
    ("godsp_tpu.dsputils", "L0 primitives: conversion, padding, predicates, comparison, Matrix."),
    ("godsp_tpu.window", "L0 tapers: the reference's six windows plus table caching."),
    ("godsp_tpu.fft", "L1 transforms: FFT/IFFT (1-D/2-D/N-D, real/complex), convolve, DCT."),
    ("godsp_tpu.spectral", "L2 spectral analysis: Welch PSD, CSD, coherence, periodogram."),
    ("godsp_tpu.wav", "RIFF/WAVE I/O with the reference's normalization quirks."),
    ("godsp_tpu.models", "Pipelines: STFT/ISTFT, spectrogram, mel/MFCC, filtering, resampling."),
    ("godsp_tpu.parallel", "Device-mesh parallelism: sharded/streaming Pwelch, TP FFT, ppermute halos."),
    ("godsp_tpu.native", "C++ host ops (decode, framing, stream FIFO) with numpy fallbacks."),
    ("godsp_tpu.utils", "Profiling, metrics/roofline, compile cache, device<->host transfer helpers."),
    ("godsp_tpu.utils.oracles", "Float64 numpy reference oracles (Welch, multi-tone spectrum)."),
]


def kind(obj) -> str:
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "fn"
    return "const"


def first_line(obj) -> str:
    if not (inspect.isclass(obj) or callable(obj)):
        # Constants inherit their TYPE's docstring (dict(), int(), ...) —
        # print the value's type instead of that nonsense.
        return f"{type(obj).__name__} constant"
    doc = inspect.getdoc(obj) or ""
    return doc.split("\n", 1)[0].strip()


def main() -> None:
    out = [
        "# API reference (generated from the public `__all__` surface)",
        "",
        "One line per public symbol; see docstrings for full semantics and",
        "reference citations (`file:line` into `/root/reference`).",
    ]
    for name, blurb in MODULES:
        mod = importlib.import_module(name)
        out += ["", f"## `{name}`", "", blurb, ""]
        for sym in sorted(getattr(mod, "__all__", [])):
            obj = getattr(mod, sym)
            out.append(f"- **`{sym}`** ({kind(obj)}) — {first_line(obj)}")
    path = os.path.join(os.path.dirname(__file__), "API.md")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
