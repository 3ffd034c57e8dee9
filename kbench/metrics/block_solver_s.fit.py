"""block_solver_s.fit: device seconds a fit spends in block updates of the
BCD solver (``parallel/linalg.py::_bcd_block_update``: the block's Gram,
right-hand side, Cholesky solve and the update of the predictions), from
the kernels launched inside the harness's range around each call."""


def read(run):
    if run.trace is None or not run.fits or "block_solver" not in run.trace.layer_s:
        return None
    return run.trace.layer_s["block_solver"] / len(run.fits)
