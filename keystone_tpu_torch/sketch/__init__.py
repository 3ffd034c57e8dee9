"""Randomized-NLA sketch tier, ported from ``keystone_tpu/sketch/``.

Stream-compatible row-space sketching operators with O(s·d) state
(``core``) and the solvers built on them (``solvers``): the third rung
of the least-squares ladder for very wide fits, plus randomized Nyström
for the kernel path. The streamed sketch carry implements the same
additive state contract the Gram family rides (``refit/state.py``), so
export, merge, ``scaled()`` and resume come with it.
"""

from .core import (
    MASK_INDEX_EXACT_ROWS,
    sketch_state_bytes,
    sketch_stream_finish,
    sketch_stream_init,
    sketch_stream_step,
)
from .solvers import (
    SketchedLeastSquaresEstimator,
    default_sketch_size,
    nystrom_krr,
    sketch_min_width,
    sketch_precond_lstsq,
)

__all__ = [
    "MASK_INDEX_EXACT_ROWS",
    "SketchedLeastSquaresEstimator",
    "default_sketch_size",
    "nystrom_krr",
    "sketch_min_width",
    "sketch_precond_lstsq",
    "sketch_state_bytes",
    "sketch_stream_finish",
    "sketch_stream_init",
    "sketch_stream_step",
]
