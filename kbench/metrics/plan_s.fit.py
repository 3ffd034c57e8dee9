"""plan_s.fit: host seconds a fit spends planning inside
``Pipeline.fit()``: the optimizer and the plan-time verifier, the port's
``plan`` span (``workflow/pipeline.py``), summed over each fit of the
traced window (the summary of the fit's ``trace()`` session,
``harness/sessions.py``), over the fits."""

from kbench.harness.sessions import window_sessions

SPAN = "plan"


def read(run):
    sessions = window_sessions(run)
    if not sessions or not any(SPAN in s.span_seconds for s in sessions):
        return None
    return sum(s.span_seconds.get(SPAN, 0.0) for s in sessions) / len(sessions)
