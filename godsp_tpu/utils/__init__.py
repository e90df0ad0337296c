"""Utilities: host transfer, timing/metrics, roofline model, the
compilation cache, and float64 reference oracles.

The aux-subsystem layer of SURVEY.md §5: the reference has no tracing,
metrics, or observability; this package provides them.
"""

from godsp_tpu.utils.cache import compile_cache_dir, enable_compile_cache
from godsp_tpu.utils.host import to_host
from godsp_tpu.utils.metrics import BenchResult, roofline, time_fn
from godsp_tpu.utils.profiling import annotate, trace_to

__all__ = [
    "to_host",
    "BenchResult",
    "roofline",
    "time_fn",
    "annotate",
    "trace_to",
    "compile_cache_dir",
    "enable_compile_cache",
]
