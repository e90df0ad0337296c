"""Tracing/profiling hooks (SURVEY.md §5: the reference has none).

Thin wrappers over jax.profiler so pipelines can be traced to
TensorBoard/XProf without importing profiler plumbing everywhere:

    with trace_to("/tmp/godsp-trace"):
        with annotate("pwelch-chunk"):
            sp.update(block)
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
from typing import Iterable, Iterator, Optional

import jax

__all__ = ["trace_to", "annotate", "start_server", "device_event_ms", "sum_device_events"]

log = logging.getLogger("godsp_tpu.profiling")


@contextlib.contextmanager
def trace_to(log_dir: str, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a device+host trace of the enclosed block into log_dir
    (viewable in TensorBoard's profile plugin / xprof)."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log.info("profile trace written to %s", log_dir)


def annotate(name: str):
    """Named span in the trace timeline (TraceAnnotation); also usable as
    a decorator via jax.profiler.annotate_function semantics."""
    return jax.profiler.TraceAnnotation(name)


def start_server(port: int = 9999) -> Optional[object]:
    """Start the on-demand profiler server (connect with TensorBoard's
    capture-profile button).  Returns the server object or None if
    unsupported on this backend."""
    try:
        return jax.profiler.start_server(port)
    except Exception as e:  # pragma: no cover - backend dependent
        log.warning("profiler server unavailable: %s", e)
        return None


def sum_device_events(planes: Iterable, keys: Iterable[str]) -> dict:
    """{device plane name: summed duration in ms} of the events whose name
    contains any of keys (case-insensitive), over the planes of a
    profiler trace whose name starts with "/device:" (host planes and
    host threads are skipped)."""
    keys = tuple(k.lower() for k in keys)
    out = {}
    for plane in planes:
        if not plane.name.startswith("/device:"):
            continue
        ns = sum(
            e.duration_ns
            for line in plane.lines
            for e in line.events
            if any(k in e.name.lower() for k in keys)
        )
        out[plane.name] = out.get(plane.name, 0.0) + ns / 1e6
    return out


def device_event_ms(trace_dir: str, keys: Iterable[str]) -> dict:
    """sum_device_events over every .xplane.pb that trace_to(trace_dir)
    wrote; e.g. keys=("nccl",) gives each GPU's collective kernel time."""
    from jax.profiler import ProfileData

    keys = tuple(keys)
    out = {}
    pattern = os.path.join(trace_dir, "**", "*.xplane.pb")
    for path in sorted(glob.glob(pattern, recursive=True)):
        for dev, ms in sum_device_events(ProfileData.from_file(path).planes, keys).items():
            out[dev] = out.get(dev, 0.0) + ms
    return out
