"""bcd_grams.fit: block Grams a fit forms in the BCD solver. The port
counts them where it forms them (``keystone_bcd_steps_total{step="gram"}``,
``parallel/linalg.py``); the reading is the counter's change over each
fit of the traced window (the summary of the fit's ``trace()`` session,
``harness/sessions.py``), over the fits. A count: passes × blocks."""

from kbench.harness.sessions import window_sessions

SERIES = "keystone_bcd_steps_total{step=gram}"


def read(run):
    sessions = window_sessions(run)
    if not sessions or not any(SERIES in s.counters for s in sessions):
        return None
    return sum(s.counters.get(SERIES, 0.0) for s in sessions) / len(sessions)
