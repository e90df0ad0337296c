"""Device -> host materialization."""

from __future__ import annotations

import numpy as np

__all__ = ["to_host"]


def to_host(x) -> np.ndarray:
    """Materialize a (possibly complex) jax array as a numpy array.

    A plain np.asarray; kept as a named entry point for its many call
    sites.  numpy inputs pass through unchanged.
    """
    return np.asarray(x)
