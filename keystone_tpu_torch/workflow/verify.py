"""Verification of persisted and published state: the resume, publish
and boot-image checks.

Port of the first part of ``keystone_tpu/workflow/verify.py``: the
diagnostic record, the report, the ``KEYSTONE_VERIFY`` enforcement mode
and the three checks the durable-fit, refit and serving layers run
before they act on state another process or another round produced:

========  ========  ====================================================
code      severity  meaning
========  ========  ====================================================
KV305     error     a refit-published candidate's apply spec or bucket
                    set disagrees with the incumbent's warmed buckets
                    (the steady-state-recompile hazard on the publish
                    path; :func:`verify_refit_publish`)
KV306     error     a persisted mid-stream resume entry's fingerprints
                    (dataset/labels content digest, featurize-chain
                    digest, featurized width/dtype) disagree with the
                    re-planned pipeline — seeding a fold from it would
                    silently corrupt the fit (:func:`verify_stream_resume`)
KV307     error     a serving boot image's fingerprints (format, torch
                    and CUDA versions, card and compute capability, the
                    kernel sources' hash, the weights digest) disagree
                    with the loading worker's (:func:`verify_boot_image`)
========  ========  ====================================================

The JAX package reads a candidate's apply spec by shape-only tracing
(``jax.eval_shape``). The port has no such tracer, so
:func:`_apply_out_spec` runs ONE apply on a one-row zero batch on the
model's own device, as ``ChunkStream.feature_aval`` does for a featurize
chain. The ``meta`` device is not used: the cuBLAS binding cannot launch
on it, so the check would read UNKNOWN on the card.

The graph verifier (shape propagation over a whole pipeline, codes
KV1xx–KV4xx and KV308) is ROADMAP Queue A item 13b and not here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..envknobs import env_str
from ..obs import names as _names
from ..utils.tree import tree_leaves, tree_map

ERROR = "error"
WARNING = "warning"

#: code → (default severity, short title), the JAX package's rows.
CODES: Dict[str, Tuple[str, str]] = {
    "KV305": (ERROR, "refit candidate disagrees with incumbent warm state"),
    "KV306": (ERROR, "stale stream-resume entry refused"),
    "KV307": (ERROR, "stale serving boot image refused"),
}


class _Unknown:
    """Singleton abstract value: statically unknowable."""

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "UNKNOWN"


UNKNOWN = _Unknown()


@dataclass
class Diagnostic:
    """One finding: a code, its severity, a message, and machine-readable
    ``details``."""

    code: str
    severity: str
    message: str
    details: Dict[str, Any] = field(default_factory=dict)

    def render(self) -> str:
        return f"{self.code} {self.severity}: {self.message}"


@dataclass
class VerifyReport:
    diagnostics: List[Diagnostic] = field(default_factory=list)
    seconds: float = 0.0
    context: str = ""

    def diag(self, code: str, message: str, **details: Any) -> None:
        severity, _title = CODES[code]
        self.diagnostics.append(Diagnostic(code=code, severity=severity, message=message, details=details))

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def render(self) -> str:
        lines = [
            f"verify[{self.context}]: {len(self.errors())} errors, "
            f"{len(self.warnings())} warnings, {len(self.diagnostics)} diagnostics, "
            f"{self.seconds * 1e3:.1f} ms"
        ]
        lines += [d.render() for d in self.diagnostics]
        return "\n".join(lines)


class VerificationError(RuntimeError):
    """Strict-mode failure: verification found errors."""

    def __init__(self, report: VerifyReport):
        self.report = report
        errors = "; ".join(d.render() for d in report.errors())
        super().__init__(
            f"verification failed ({report.context}): {errors} "
            "— set KEYSTONE_VERIFY=warn to downgrade"
        )


def verification_mode() -> str:
    """``KEYSTONE_VERIFY``: ``warn`` (default — log and continue),
    ``strict`` (errors raise :class:`VerificationError`), ``off``."""
    raw = env_str("KEYSTONE_VERIFY", "warn").lower()
    if raw in ("off", "0", "disabled", "none"):
        return "off"
    if raw == "strict":
        return "strict"
    return "warn"


def _publish(report: VerifyReport, context: str) -> None:
    _names.metric(_names.VERIFY_RUNS).inc(context=context)
    _names.metric(_names.VERIFY_SECONDS).observe(report.seconds)
    diag_c = _names.metric(_names.VERIFY_DIAGNOSTICS)
    for d in report.diagnostics:
        diag_c.inc(code=d.code, severity=d.severity)


# -------------------------------------------------------------- KV305


def _model_device(model: Any) -> Optional[torch.device]:
    """The device of the first tensor among ``model``'s attributes (the
    operators' attributes for a fitted pipeline), else its ``device``
    attribute; None when neither says."""
    objs = [model]
    graph = getattr(model, "graph", None)
    if graph is not None:
        objs += list(getattr(graph, "operators", {}).values())
        objs += [m for op in objs[1:] for m in getattr(op, "members", ())]
    for obj in objs:
        for value in vars(obj).values() if hasattr(obj, "__dict__") else ():
            for leaf in tree_leaves(value) if isinstance(value, (tuple, list, dict)) else (value,):
                if isinstance(leaf, torch.Tensor):
                    return leaf.device
    device = getattr(model, "device", None)
    return torch.device(device) if device is not None else None


def _apply_out_spec(model: Any, example: Any):
    """A fitted model's per-row output spec for one request payload: ONE
    apply on a one-row zero batch on the model's device. Returns a
    ``(kind, rendering)`` pair — ``arrays`` for an ``apply_arrays``
    model, ``batch`` for one applied through ``apply_batch`` (a fitted
    pipeline); the caller compares only like kinds. UNKNOWN when the
    model's device cannot be told or the apply fails."""
    from ..data.dataset import ArrayDataset

    device = _model_device(model)
    if device is None:
        return UNKNOWN

    def zero_row(a):
        dtype = getattr(a, "dtype", None)
        if isinstance(a, torch.Tensor):
            return torch.zeros((1,) + tuple(a.shape), dtype=a.dtype)
        return np.zeros((1,) + np.shape(a), np.dtype(dtype) if dtype is not None else np.asarray(a).dtype)

    def render(out) -> str:
        return repr(tree_map(lambda a: (tuple(a.shape[1:]), str(a.dtype)), out))

    try:
        batch = ArrayDataset(tree_map(zero_row, example), device=device)
        apply_arrays = getattr(model, "apply_arrays", None)
        if apply_arrays is not None:
            with torch.no_grad():
                return ("arrays", render(apply_arrays(batch.data)))
        apply_batch = getattr(model, "apply_batch", None)
        if apply_batch is None:
            return UNKNOWN
        with torch.no_grad():
            out = apply_batch(batch)
        return ("batch", render(getattr(out, "data", out)))
    except Exception:
        return UNKNOWN


def verify_refit_publish(
    candidate: Any,
    incumbent: Any,
    example: Any = None,
    buckets: Optional[Sequence[int]] = None,
    warmed_buckets: Optional[Sequence[int]] = None,
    context: str = "refit-publish",
) -> VerifyReport:
    """The publish-path face of the steady-state-recompile hazard (KV305).

    A refit-published candidate serves at the INCUMBENT's warmed bucket
    shapes: a candidate whose per-row output spec or required bucket set
    disagrees with what the incumbent warmed would meet cold shapes on
    live traffic after the publish settled. Runs before every controller
    publish."""
    t0 = time.perf_counter()
    report = VerifyReport(context=context)

    if buckets is not None:
        want = set(int(b) for b in buckets)
        warmed = set(int(b) for b in (warmed_buckets or ()))
        missing = sorted(want - warmed)
        if missing:
            report.diag(
                "KV305",
                f"candidate's serving buckets {missing} are not in the "
                f"incumbent's warmed set {sorted(warmed)} — every batch "
                "padded onto them meets a cold shape at serve time, AFTER "
                "the publish settled (re-warm the new buckets before swapping)",
                missing=missing,
                warmed=sorted(warmed),
            )

    if example is not None and incumbent is not None:
        cand_out = _apply_out_spec(candidate, example)
        inc_out = _apply_out_spec(incumbent, example)
        if (
            cand_out is not UNKNOWN
            and inc_out is not UNKNOWN
            # Same apply door only: renderings are not comparable
            # across kinds.
            and cand_out[0] == inc_out[0]
            and cand_out[1] != inc_out[1]
        ):
            report.diag(
                "KV305",
                f"candidate's apply spec {cand_out[1]} != incumbent's "
                f"{inc_out[1]} for the same request — the warmed shapes "
                "cannot serve it (shape/dtype drift in the refit candidate)",
                candidate_spec=str(cand_out[1]),
                incumbent_spec=str(inc_out[1]),
            )

    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


# -------------------------------------------------------------- KV306

#: cursor field → title, in the order the JAX package checks them.
RESUME_FINGERPRINTS: Tuple[Tuple[str, str], ...] = (
    ("dataset_digest", "dataset content digest"),
    ("labels_digest", "labels content digest"),
    ("chain_digest", "featurize-chain digest"),
    ("feature_width", "featurized width"),
    ("feature_dtype", "featurized dtype"),
)


def verify_stream_resume(cursor: Any, current: Dict[str, Any], context: str = "stream-resume") -> VerifyReport:
    """The durable-fit face of stale-state corruption (KV306).

    A mid-stream resume entry seeds a fold with statistics captured over
    a PREFIX of the dataset — sound only when the re-planned pipeline
    reproduces the exact same features for the exact same rows. Any
    disagreement between the cursor's fingerprints and ``current`` (the
    same field names, the re-planned pipeline's values) refuses the
    entry. Pure host-side comparison, no device work."""
    t0 = time.perf_counter()
    report = VerifyReport(context=context)
    for field_name, title in RESUME_FINGERPRINTS:
        have = getattr(cursor, field_name)
        want = current.get(field_name)
        if have != want:
            report.diag(
                "KV306",
                f"resume entry's {title} ({str(have)[:16]}) disagrees with "
                f"the re-planned pipeline's ({str(want)[:16]}) — seeding "
                "the fold from this entry would silently corrupt the fit; "
                "the entry is refused and the fit re-ingests from scratch",
                field=field_name,
                entry=str(have)[:16],
                planned=str(want)[:16],
            )
    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


# -------------------------------------------------------------- KV307

#: manifest/environment fields verify_boot_image compares, with the human
#: titles its diagnostics use. serving/bootimage.py builds both sides.
BOOT_IMAGE_FINGERPRINTS: Tuple[Tuple[str, str], ...] = (
    ("format_version", "artifact format version"),
    ("torch_version", "torch version"),
    ("cuda_version", "CUDA version"),
    ("device_name", "device"),
    ("compute_capability", "compute capability"),
    ("kernel_sources", "kernel sources hash"),
    ("weights_digest", "fitted-weights digest"),
)


def verify_boot_image(
    manifest: Dict[str, Any], current: Dict[str, Any], context: str = "boot-image"
) -> VerifyReport:
    """The serving face of stale-state corruption (KV307).

    A boot image carries the fitted weights, the kernel libraries the
    model's apply loads and the parity digests of its build — sound to
    serve from only when the loading worker's environment matches the
    builder's: the same artifact format, torch and CUDA versions (the
    pickled model and the libraries' ABI), the same card and compute
    capability (libraries built for ``sm_90a``; digests of products on
    that card), the same kernel sources (a library built from other
    sources must not be placed where ``_build`` looks), and the same
    weights digest (a ``model.pkl`` that is not the one the digests were
    taken from). Any disagreement refuses the image: the worker falls
    back to the classic warm path — slower first request, never garbage.
    Pure host-side comparison, no device work."""
    t0 = time.perf_counter()
    report = VerifyReport(context=context)
    for field_name, title in BOOT_IMAGE_FINGERPRINTS:
        have = manifest.get(field_name)
        want = current.get(field_name)
        if have != want:
            report.diag(
                "KV307",
                f"boot image's {title} ({str(have)[:24]}) disagrees with "
                f"this worker's ({str(want)[:24]}) — serving from it could "
                "return garbage; the image is refused and the worker warms "
                "through the classic path",
                field=field_name,
                image=str(have)[:24],
                worker=str(want)[:24],
            )
    report.seconds = time.perf_counter() - t0
    _publish(report, context)
    return report


__all__ = [
    "CODES",
    "Diagnostic",
    "UNKNOWN",
    "VerificationError",
    "VerifyReport",
    "verification_mode",
    "verify_boot_image",
    "verify_refit_publish",
    "verify_stream_resume",
]
