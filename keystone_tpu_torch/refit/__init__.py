"""Continuous refit: a live-traffic incremental retraining loop.

Port of ``keystone_tpu/refit/`` on one device:

- :mod:`state`   — the stream-state contract: estimators export their
                   mergeable sufficient statistics, extend them later
                   (``fit_stream(..., state=)``), merge partials, and
                   finish a fitted transformer from statistics alone;
                   persisted through the reliability checkpoint store.
- :mod:`tap`     — the traffic tap: a bounded spill buffer fed by served
                   requests (sampled) and a labeled side-channel, with
                   drop-counting backpressure that never blocks serving.
- :mod:`shadow`  — shadow evaluation of a candidate against the
                   incumbent on held-out labels and mirrored traffic.
- :mod:`publish` — :class:`InProcessPublisher` (registry hot-swap,
                   bucket re-warm, KV305 gate, O(1) rollback) and
                   :class:`SupervisorPublisher` (checkpoint store + the
                   fleet's swap broadcast).
- :mod:`daemon`  — the supervised tap → fold → shadow → publish → watch
                   loop with its round journal, and the drifting-workload
                   demo behind ``python -m keystone_tpu_torch refit``.

The daemon's scheduler lease is ROADMAP item 13b. Exports resolve lazily (PEP 562): the Gram estimators import
:mod:`state` at module scope, and pulling the whole control plane in
from there would slow that import and risk cycles.
"""

from __future__ import annotations

_LAZY = {
    "GramStreamStateMixin": "keystone_tpu_torch.refit.state",
    "StateMismatch": "keystone_tpu_torch.refit.state",
    "StreamState": "keystone_tpu_torch.refit.state",
    "load_stream_state": "keystone_tpu_torch.refit.state",
    "merge_stream_states": "keystone_tpu_torch.refit.state",
    "save_stream_state": "keystone_tpu_torch.refit.state",
    "stream_state_key": "keystone_tpu_torch.refit.state",
    "TrafficTap": "keystone_tpu_torch.refit.tap",
    "ShadowEvaluator": "keystone_tpu_torch.refit.shadow",
    "ShadowReport": "keystone_tpu_torch.refit.shadow",
    "InProcessPublisher": "keystone_tpu_torch.refit.publish",
    "PublishTicket": "keystone_tpu_torch.refit.publish",
    "SupervisorPublisher": "keystone_tpu_torch.refit.publish",
    "RefitConfig": "keystone_tpu_torch.refit.daemon",
    "RefitDaemon": "keystone_tpu_torch.refit.daemon",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
