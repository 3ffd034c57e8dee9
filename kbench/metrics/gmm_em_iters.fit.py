"""gmm_em_iters.fit: EM iterations a fit runs in its mixture. The port
counts them where it runs them (``keystone_gmm_steps_total{step="em"}``,
``ops/learning/gmm.py``); the reading is the counter's change over each
fit of the traced window (the summary of the fit's ``trace()`` session,
``harness/sessions.py``), over the fits. A count; a port that does not
publish the series gives no reading."""

from kbench.harness.sessions import window_sessions

SERIES = "keystone_gmm_steps_total{step=em}"


def read(run):
    sessions = window_sessions(run)
    if not sessions or not any(SERIES in s.counters for s in sessions):
        return None
    return sum(s.counters.get(SERIES, 0.0) for s in sessions) / len(sessions)
