"""fit_mfu: the whole fit's share of the card's published peak.

The operations one fit needs (``counts/<config>.py``, from the
configuration's shapes) times the fits of the traced window, over the
window's time, over the data-sheet peak of the product kind the fit runs
at (the configuration's ``product_kind``; ``refine`` runs IEEE fp32, 67
TFLOP/s on an H100 SXM). In %.
"""

from kbench.harness.peaks import KIND_PEAK


def read(run):
    peaks = run.peaks
    if not run.fits or peaks is None or run.window_s <= 0:
        return None
    flops = run.counts().fit_flops(run.config) * len(run.fits)
    return 100.0 * flops / (run.window_s * peaks[KIND_PEAK[run.config["product_kind"]]])
