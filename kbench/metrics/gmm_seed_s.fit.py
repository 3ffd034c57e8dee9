"""gmm_seed_s.fit: host seconds a fit spends seeding its mixture's
k-means++ (the port's ``kmeans:seed`` spans, ``ops/learning/kmeans.py``:
the D² draws over the GMM sample on the host), summed over each fit of
the traced window (the summary of the fit's ``trace()`` session,
``harness/sessions.py``), over the fits."""

from kbench.harness.sessions import window_sessions

SPAN = "kmeans:seed"


def read(run):
    sessions = window_sessions(run)
    if not sessions or not any(SPAN in s.span_seconds for s in sessions):
        return None
    return sum(s.span_seconds.get(SPAN, 0.0) for s in sessions) / len(sessions)
