"""The port's own record of the traced window's fits.

Each fit of a traced run is one ``workflow/tracing.py::trace()``
session, named ``pipeline``. When a session closes the port keeps a
summary of it (``obs/spans.py::recent_sessions``: seconds and count by
span name, and the registry's series that moved while it was open).
Nothing else in a fit cell opens such a session after the window, so
the window's fits are the last of them, one each.
"""

from __future__ import annotations

from typing import Any, List, Optional

SESSION_NAME = "pipeline"


def window_sessions(run) -> Optional[List[Any]]:
    """The summaries of the window's fits, oldest first; None where the
    run was not traced or the port keeps no summaries."""
    if not run.traced or not run.fits:
        return None
    try:
        from keystone_tpu_torch.obs.spans import recent_sessions
    except ImportError:
        return None
    found = [s for s in recent_sessions() if s.name == SESSION_NAME]
    if len(found) < len(run.fits):
        return None
    return found[-len(run.fits):]
