"""``python -m keystone_tpu_torch quality`` — the quality-plane report.

Port of ``keystone_tpu/obs/quality_cli.py``. Runs a deterministic seeded
traffic scenario through a fresh
:class:`~keystone_tpu_torch.obs.quality.QualityPlane` (standard library
only — no torch, no serving stack) and prints the operator-facing report:
per-model score summaries, drift state, open sequential tests, and
archived decisions with their evidence. The final
``QUALITY_STATS:{...}`` JSON line is the machine contract.

The scenario: a baseline window of Gaussian scores is observed and
frozen as the drift reference, then a current window — shifted by
``--shift`` baseline standard deviations — is served against it while a
candidate-vs-incumbent :class:`SequentialGate` compares the two streams
pairwise. With ``--shift 0`` (clean traffic) the gate must stay open and
the drift detector quiet: ZERO decisions, ZERO drift events, exit 0.
With a real shift the detector fires exactly one edge-triggered drift
event, the gate decides ``rollback``, and the process exits 2.

Exit codes: 0 quiet, 2 drift detected or rollback decided.
"""

from __future__ import annotations

import json
import random
from typing import List

# score distribution for the synthetic streams: mean/std chosen so the
# default drift threshold (0.5 sigma) sits well clear of seeded noise.
_BASE_MEAN = 1.0
_BASE_STD = 0.1


def add_quality_arguments(parser) -> None:
    """Flags for ``quality`` (plain argparse — the CLI's --help path
    imports no torch)."""
    parser.add_argument(
        "--rows", type=int, default=256,
        help="scores per window (baseline and current each see this many)",
    )
    parser.add_argument(
        "--shift", type=float, default=0.0,
        help="quality REGRESSION in the current window, in baseline "
        "standard deviations (scores drop by this many sigmas; 0 = clean "
        "traffic, the smoke's drift case uses ~3)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model", default="default")
    parser.add_argument(
        "--features", type=int, default=4,
        help="payload feature coordinates sketched per request",
    )
    parser.add_argument(
        "--alpha", type=float, default=None,
        help="sequential-gate false-positive bound "
        "(default KEYSTONE_QUALITY_ALPHA, 0.05)",
    )
    parser.add_argument(
        "--max-samples", type=int, default=None,
        help="gate sample budget (default: one more than the scenario "
        "feeds, so a clean run ends with the test still OPEN — no "
        "decision without evidence)",
    )
    parser.add_argument(
        "--labels", type=int, default=64,
        help="delayed labels joined into the labeled stream (shows the "
        "label-join path in the report)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print only the QUALITY_STATS: line (skip the human report)",
    )


def _window(rng: random.Random, n: int, mean: float) -> List[float]:
    return [rng.gauss(mean, _BASE_STD) for _ in range(n)]


def _human_report(report: dict, decay: dict) -> List[str]:
    lines: List[str] = []
    for model, view in sorted(report["models"].items()):
        lines.append(f"model {model}")
        for role, summary in sorted(view["streams"].items()):
            lines.append(
                "  stream %-8s n=%-6d mean=%-10s p50=%s"
                % (role, summary["count"], summary["mean"], summary.get("p50"))
            )
        drift = view["drift"]
        lines.append(
            "  drift    score=%.4f threshold=%s events=%d %s"
            % (
                drift["score"], drift["threshold"], drift["events"],
                "DRIFTING" if drift["drifting"] else "quiet",
            )
        )
        lines.append(
            "  decay    suggested state_decay=%s (base 1.0)"
            % decay.get(model)
        )
        lines.append("  labels   joined=%d" % view["label_joins"])
        sketch = view.get("sketch")
        if sketch:
            lines.append(
                "  sketch   rows=%d channels=%d"
                % (sketch["rows"], len(sketch["channels"]))
            )
    for gate in report["open_gates"]:
        lines.append(
            "open gate %s:%s samples=%d/%d lr=%s"
            % (gate["model"], gate["kind"], gate["samples"],
               gate["max_samples"], gate["lr"])
        )
    for decision in report["decisions"]:
        lines.append(
            "decision %s %s after %d samples (lr=%s alpha=%s%s)"
            % (
                decision["model"], decision["decision"].upper(),
                decision["samples"], decision["lr"], decision["alpha"],
                ", budget exhausted" if decision["budget_exhausted"] else "",
            )
        )
    return lines


def quality_from_args(args) -> int:
    from .quality import QualityPlane

    rng = random.Random(args.seed)
    plane = QualityPlane()
    model = args.model

    # Baseline window: live traffic before the change under watch.
    baseline = _window(rng, args.rows, _BASE_MEAN)
    for score in baseline:
        row = [rng.gauss(0.0, 1.0) for _ in range(args.features)]
        plane.observe_served(model, row, score)
    plane.drift(model).freeze_baseline()

    # Delayed labels land for part of the baseline window.
    if args.labels > 0:
        plane.join_labels(model, baseline[: args.labels])

    # Current window, degraded by --shift baseline sigmas, gated pairwise
    # against a replay of the baseline scores. The default budget sits
    # just above the scenario's sample count: an anytime-valid test with
    # no evidence ends OPEN, it does not decide.
    max_samples = (
        args.max_samples if args.max_samples is not None else 2 * args.rows + 2
    )
    gate = plane.open_gate(model, alpha=args.alpha, max_samples=max_samples)
    current = _window(rng, args.rows, _BASE_MEAN - args.shift * _BASE_STD)
    drift_events = 0
    for cand, base in zip(current, baseline):
        row = [rng.gauss(0.0, 1.0) for _ in range(args.features)]
        plane.observe_served(model, row, cand)
        if plane.check_drift(model) is not None:
            drift_events += 1
        if gate.decision is None:
            if gate.observe(candidate=cand, baseline=base) != "continue":
                plane.record_decision(gate)

    # Fleet path: the pending worker delta merges like a heartbeat would.
    delta = plane.drain_delta()
    if delta is not None:
        plane.merge_delta(delta, role="worker")

    decay = {model: plane.suggested_decay(model, base=1.0)}
    report = plane.report()
    decisions = [d["decision"] for d in report["decisions"]]
    rollbacks = decisions.count("rollback")
    stats = {
        "model": model,
        "rows": args.rows,
        "shift": args.shift,
        "seed": args.seed,
        "drift_events": drift_events,
        "decisions": decisions,
        "rollbacks": rollbacks,
        "state_decay": decay,
        "report": report,
    }
    if not args.as_json:
        for line in _human_report(report, decay):
            print(line)
    print("QUALITY_STATS:" + json.dumps(stats), flush=True)
    return 2 if (drift_events or rollbacks) else 0
