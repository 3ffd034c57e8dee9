"""Refit, ported from ``keystone_tpu/refit/``: so far the in-memory
stream-state contract (:mod:`state`). Persistence, the traffic tap,
shadow evaluation, publishing and the daemon are not ported yet."""
