"""The one place process environment knobs are read.

A copy of ``keystone_tpu/envknobs.py``'s typed readers (the port keeps
its own copy rather than importing the JAX package). Every knob is read
at CALL time, never at import, so tests can monkeypatch the environment
and both packages see the same variables with the same meaning.
"""

from __future__ import annotations

import os

#: Spellings that mean "off" for default-on feature switches.
_OFF_VALUES = ("off", "0", "disabled")

#: Spellings that mean "on" for default-off switches.
_ON_VALUES = ("1", "true", "on", "yes")


def env_raw(name: str):
    """The raw value, or ``None`` when unset (knobs whose precedence
    depends on presence, like ``KEYSTONE_SOLVER_PRECISION``)."""
    return os.environ.get(name)


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def env_set(name: str) -> bool:
    """True when ``name`` is present and non-empty."""
    return bool(os.environ.get(name, "").strip())


def env_int(name: str, default: int) -> int:
    """Integer knob; accepts float spellings like ``4e9``."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    return int(float(raw))


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    return float(raw)


def env_flag(name: str, default: bool = False) -> bool:
    """Default-off boolean switch: on iff the value spells true."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() in _ON_VALUES


def env_disabled(name: str) -> bool:
    """True when a default-ON feature switch is explicitly off
    (``off``/``0``/``disabled``)."""
    return os.environ.get(name, "").lower() in _OFF_VALUES
