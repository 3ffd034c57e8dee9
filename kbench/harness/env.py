"""Process facts a run reports: its age, the card, and the modules it
must not have loaded."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

#: Top-level module names a run may not hold: JAX, its libraries, and the
#: JAX package the port was made from. Compared whole: the port's own
#: name, ``keystone_tpu_torch``, begins with the JAX package's.
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "keystone_tpu")

_FALLBACK_START = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (clock ticks
    since boot), so the interpreter's own start counts; the time since
    this module was imported where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _FALLBACK_START


def forbidden_modules(modules: Optional[Dict[str, object]] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN_TOP_LEVEL`."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in modules if name.split(".", 1)[0] in FORBIDDEN_TOP_LEVEL)


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
