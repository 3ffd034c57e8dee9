"""gemm_roofline.fit: the cuBLAS binding's share of its roofline in fits.

For every call of the binding's entry points in the traced window
(``ops/cuda/gemm.py``: shape and product kind recorded by the harness's
wrapper), the least time the card could take, max(FLOP / the kind's
peak, bytes / 3.35 TB/s) with FLOP and bytes from ``harness/peaks.py``
(a Gram, both operands one matrix, counted as its symmetric half),
summed, over the summed device time of the kernels each call launched
(from the profiler's trace). In %.
"""

from kbench.harness.peaks import gemm_counts, least_seconds


def read(run):
    peaks = run.peaks
    if run.trace is None or peaks is None or not run.fits:
        return None
    least = device = 0.0
    for index, call in enumerate(run.gemm_calls):
        seconds = run.trace.gemm_s.get(index)
        if not seconds:
            continue
        flops, nbytes = gemm_counts(call.m, call.n, call.k, call.itemsize, call.batch, call.accumulate, call.gram)
        least += least_seconds(flops, nbytes, call.kind, peaks)
        device += seconds
    return 100.0 * least / device if device > 0 else None
