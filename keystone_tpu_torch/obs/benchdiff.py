"""bench-diff: run-over-run benchmark comparison with a regression verdict.

Port of ``keystone_tpu/obs/benchdiff.py``; standard library only. Given a
baseline artifact and a current one it compares every shared leg with
*noise-aware* rules and emits a verdict (exit code 1 on regression).
The port's artifacts are ``chip_smoke.py``'s phase lines gathered into
one object per phase, with ``"platform": "gpu"``.

Comparison rules, per flattened leg key:

- **counts** (``*dispatches*``, ``compiles_first_chunk``,
  ``compiles_steady_state``, ``chunks``, ``*dropped*``) are compared
  **exactly** — a structural regression no tolerance should forgive.
- **timings** (``*_ms``, ``*_s``, ``*_seconds``) are compared as ratios
  with a configurable tolerance (default ±50%) and an absolute floor
  (default 50 ms). Skipped entirely unless BOTH artifacts declare the
  SAME platform: a baseline from one platform (a TPU, the host, a card)
  never gates a run from another, and a truncated wrapper with no
  platform key may carry either.
- **parity** (``parity_rel_err``) is bounded: worse than 10× baseline
  AND above 1e-3 flags a numerical regression.
- **booleans** (``overlap_ok``) regress on true→false.
- **config** keys (``n``, ``d``, ``k``, ``shape``, ``iters``, …) must
  match for a leg to be comparable at all; mismatched legs are reported
  ``incomparable`` and skipped.
- legs that errored/skipped in the BASELINE are skipped; a leg that was
  healthy in the baseline but errors NOW is itself a regression.

Artifact formats accepted: the driver wrapper (``{"tail": ...}`` with
the result JSON inside the tail — possibly truncated, in which case
whole-leg objects are still recovered line-by-line), a single-line
result or partial dump, and a raw child report.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

# Leg-level keys that are run metadata, never measurements.
_META_KEYS = {
    "platform", "device_kind", "backend_init_s", "small_shapes",
    "compilation_cache", "diagnostics", "metric", "value", "unit",
    "vs_baseline", "partial", "phase", "best_onchip_run",
}
_CONFIG_KEYS = {
    "n", "d", "k", "shape", "iters", "chain_nodes", "num_epochs",
    "chunks", "chunk_rows", "block_size", "mode", "method",
    "requests", "solver_precision",
}
_EXACT_SUBSTRINGS = (
    "dispatches", "compiles_first_chunk", "compiles_steady_state",
    "bytes_transferred",  # deterministic for a pinned dataset + dtype plan
    "dropped",  # serving chaos invariant: a dropped request is never OK
    # Partitioner invariants: shard counts and the
    # finish-reduce payload are pure functions of the pinned plan.
    "collective_bytes", "shards_chosen",
    # Block-sparse invariants: density and skipped
    # tiles are pure functions of the deterministic corpus + hash.
    "density", "blocks_skipped",
    # Continuous-refit invariants: the deterministic
    # drifting workload publishes, skips, and rolls back EXACTLY the
    # same rounds every run — a changed count is a changed loop.
    "publishes", "rollbacks", "skips",
    # Cost-observatory invariant: harvesting must compile or build
    # NOTHING — any nonzero count is a broken harvest path.
    "harvest_compiles",
    # Quality-plane invariant:
    # the sequential gate's decision count is deterministic in the
    # seeded loop — a pure serving sweep decides nothing, the refit
    # demo decides exactly its seeded rounds. (quality_sketch_bytes
    # stays under the skip list's generic "bytes" — heartbeat timing
    # shapes what a killed worker managed to ship.)
    "quality_decisions",
    # Sketched-tier invariant: the sketch/Gram state
    # footprints are pure functions of (s, d, k) — a changed byte count
    # is a changed state layout, not noise. (Matched before the skip
    # list's generic "bytes".)
    "state_bytes",
    # Co-scheduler invariants: the cosched leg's
    # seeded pressure window admits, defers, preempts, and resumes
    # EXACTLY the same leases every run — a changed count is a changed
    # admission policy, not noise.
    "leases", "preemptions",
)
_SKIP_SUBSTRINGS = (
    # Environment-dependent measurements no two runs share: compile
    # counts depend on persistent-cache warmth, RSS/memory on the host.
    "xla_compiles", "rss", "memory", "bytes", "obs.",
    "adopted_from_capture", "stall_s",  # prefetch stalls are scheduler noise
    # Block-sparse leg kernel walls: sub-second and observed swinging
    # ≥4× with ambient load on shared CI boxes. The verdict rides the
    # IN-RUN ratios instead (speedup_ok bool + exact density counts),
    # where both paths see the same ambient load.
    "_gram_wall_s", "_fit_wall_s",
    # Refit leg fold walls: same story — the gate is the in-run
    # refit_speedup ratio (speedup_ok bool), not sub-second absolutes.
    "_refit_wall_s",
)


# ------------------------------------------------------------------ loading


def _iter_json_objects(text: str):
    """Yield every parseable top-level JSON object embedded in ``text``
    (driver tails mix logs and JSON, and may truncate the head)."""
    decoder = json.JSONDecoder()
    i = 0
    while True:
        start = text.find("{", i)
        if start < 0:
            return
        try:
            obj, consumed = decoder.raw_decode(text[start:])
        except json.JSONDecodeError:
            i = start + 1
            continue
        yield obj
        i = start + consumed


def _looks_like_report(obj: Any) -> bool:
    return isinstance(obj, dict) and (
        "platform" in obj
        or "metric" in obj
        or any(
            isinstance(v, dict) and ("wall_s" in v or "error" in v)
            for v in obj.values()
        )
    )


def load_bench_report(path: str) -> Dict[str, Any]:
    """Best-effort extraction of a ``{leg: {...}}`` report from any of
    the artifact shapes the bench ecosystem produces."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "tail" in data and isinstance(data.get("tail"), str):
        # Driver wrapper: the report is embedded in (possibly truncated)
        # stdout. Prefer the largest report-shaped object; fall back to
        # stitching whole-leg objects out of a truncated head.
        candidates = [
            o for o in _iter_json_objects(data["tail"]) if _looks_like_report(o)
        ]
        if candidates:
            return max(candidates, key=lambda o: len(json.dumps(o)))
        report: Dict[str, Any] = {}
        for key, obj in _iter_leg_fragments(data["tail"]):
            report[key] = obj
        if report:
            return report
        raise ValueError(f"{path}: no report JSON recoverable from tail")
    return data


def _iter_leg_fragments(tail: str):
    """Recover ``"leg": {...}`` fragments from a truncated JSON tail —
    the committed driver artifacts keep only the last N bytes, which
    beheads the outer object but leaves whole legs intact."""
    decoder = json.JSONDecoder()
    i = 0
    while True:
        q = tail.find('": {', i)
        if q < 0:
            return
        # backtrack to the opening quote of the key
        k = tail.rfind('"', 0, q)
        if k < 0:
            i = q + 1
            continue
        key = tail[k + 1:q]
        try:
            obj, consumed = decoder.raw_decode(tail[q + 3:])
        except json.JSONDecodeError:
            i = q + 1
            continue
        if isinstance(obj, dict) and ("wall_s" in obj or "error" in obj
                                      or "fit_ms" in obj):
            yield key, obj
        i = q + 3 + consumed


def report_legs(report: Dict[str, Any]) -> List[str]:
    return sorted(
        k for k, v in report.items()
        if k not in _META_KEYS and isinstance(v, dict)
    )


# ---------------------------------------------------------------- comparison


def _flatten(leg: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in leg.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _classify(key: str) -> str:
    leaf = key.rsplit(".", 1)[-1]
    # obs.* keys are whole-registry deltas spanning warmups and incidental
    # applies — environment-shaped even when they mention dispatches; the
    # pinned invariants live at leg level (fused_dispatches_per_apply,
    # streaming_report.*), so the skip wins over the exact substrings here.
    if key.startswith("obs.") or ".obs." in key:
        return "skip"
    if any(s in key for s in _EXACT_SUBSTRINGS):
        return "exact"
    if leaf == "source" or leaf.endswith("_source"):
        # Provenance fields (tuned vs observed vs default knob choices):
        # a silent flip of where a decision came
        # from is exactly what post-hoc debugging needs surfaced.
        return "exact"
    if leaf == "chunks":
        # top-level "chunks" is leg config (n / chunk_rows); the nested
        # streaming_report.chunks is the MEASURED count — an invariant
        return "exact" if "." in key else "config"
    if any(s in key for s in _SKIP_SUBSTRINGS) or leaf == "wall_s":
        return "skip"  # leg wall_s includes warmup/compile — not a measure
    if leaf in _CONFIG_KEYS:
        return "config"
    if leaf == "parity_rel_err":
        return "parity"
    if leaf.endswith(("_ms", "_s", "_seconds")):
        return "timing"
    return "info"


def compare_leg(
    base: Dict[str, Any],
    cur: Dict[str, Any],
    tolerance: float,
    min_seconds: float,
    timings_comparable: bool,
) -> Dict[str, Any]:
    """Compare one leg; returns ``{"status", "checks", ...}`` where
    status is ok | improved | regression | skipped | incomparable."""
    if "error" in base or "skipped" in base or "truncated" in base:
        return {"status": "skipped", "note": "baseline leg has no clean data"}
    if "error" in cur or "skipped" in cur or "truncated" in cur:
        # a leg that used to finish cleanly and now errors OR blows its
        # child deadline (truncated partial data) is exactly the case
        # this gate exists for
        reason = cur.get("error", cur.get("skipped", cur.get("truncated")))
        return {
            "status": "regression",
            "note": f"leg regressed to failure: {reason}"[:300],
        }
    fb, fc = _flatten(base), _flatten(cur)
    checks: List[Dict[str, Any]] = []
    regressions = improvements = 0
    for key in sorted(set(fb) & set(fc)):
        kind = _classify(key)
        b, c = fb[key], fc[key]
        if isinstance(b, bool) or isinstance(c, bool):
            # invariant flags (overlap_ok, extrapolated): true→false is a
            # regression regardless of what the key name classifies as
            if bool(b) and not bool(c):
                checks.append({"key": key, "kind": "bool", "base": b,
                               "current": c, "verdict": "regression"})
                regressions += 1
            continue
        if kind in ("skip", "info"):
            continue
        if kind == "config":
            if b != c:
                return {
                    "status": "incomparable",
                    "note": f"config mismatch at {key}: {b!r} vs {c!r}",
                }
            continue
        if not isinstance(b, (int, float)) or not isinstance(c, (int, float)):
            # An exact-gated invariant must not evaporate when the value
            # degrades to None/non-numeric — that happens precisely when
            # the measured path is broken (e.g. compiles_steady_state is
            # None because no worker stats flowed), the one run the gate
            # exists to catch.
            if kind == "exact" and b != c:
                checks.append({"key": key, "kind": "exact", "base": b,
                               "current": c, "verdict": "regression"})
                regressions += 1
            continue
        if kind == "exact":
            verdict = "ok" if b == c else "regression"
            checks.append({"key": key, "kind": "exact", "base": b,
                           "current": c, "verdict": verdict})
            regressions += verdict == "regression"
        elif kind == "parity":
            bad = c > max(10.0 * max(b, 0.0), 1e-3)
            checks.append({"key": key, "kind": "parity", "base": b,
                           "current": c,
                           "verdict": "regression" if bad else "ok"})
            regressions += bad
        elif kind == "timing":
            if not timings_comparable:
                continue
            floor = min_seconds * (1000.0 if key.endswith("_ms") else 1.0)
            if b <= 0 or (b < floor and c < floor):
                continue
            ratio = c / b
            if ratio > 1.0 + tolerance and (c - b) > floor:
                verdict = "regression"
                regressions += 1
            elif ratio < 1.0 - tolerance:
                verdict = "improved"
                improvements += 1
            else:
                verdict = "ok"
            checks.append({"key": key, "kind": "timing", "base": b,
                           "current": c, "ratio": round(ratio, 3),
                           "verdict": verdict})
    for key in sorted(set(fb) - set(fc)):
        # Same rule for an invariant that DISAPPEARED from the current
        # run: a renamed or no-longer-measured exact key — or a bool
        # invariant that held true in the baseline (overlap_ok) — fails
        # loudly instead of silently un-gating itself.
        b = fb[key]
        kind = _classify(key)
        if kind == "exact":
            checks.append({"key": key, "kind": "exact", "base": b,
                           "current": None, "verdict": "regression"})
            regressions += 1
        elif kind != "skip" and isinstance(b, bool) and b:
            checks.append({"key": key, "kind": "bool", "base": b,
                           "current": None, "verdict": "regression"})
            regressions += 1
    status = "ok"
    if regressions:
        status = "regression"
    elif improvements and not regressions:
        status = "improved"
    return {"status": status, "checks": checks}


def diff_reports(
    baseline: Dict[str, Any],
    current: Dict[str, Any],
    legs: Optional[List[str]] = None,
    tolerance: float = 0.5,
    min_seconds: float = 0.05,
) -> Dict[str, Any]:
    base_platform = baseline.get("platform")
    cur_platform = current.get("platform")
    # Timings compare only when BOTH artifacts declare the same platform.
    # Unknown counts as incomparable: a truncated driver wrapper loses the
    # outer "platform" key while its recovered legs may be TPU walls —
    # ratio-ing those against CPU CI walls would be noise presented as a
    # verdict. Counts stay exact either way.
    timings_comparable = (
        base_platform is not None
        and cur_platform is not None
        and base_platform == cur_platform
    )
    # Legs the caller named explicitly (CI's --legs fusion,streaming) are
    # REQUIRED: a typo'd name, a renamed bench leg, or a regenerated
    # baseline that lost a leg must fail the gate, not leave it green
    # forever while comparing nothing. Auto-discovered legs (the union
    # sweep) still skip one-sided entries — artifacts legitimately differ
    # in coverage.
    required = legs is not None
    selected = legs or sorted(set(report_legs(baseline)) | set(report_legs(current)))
    out_legs: Dict[str, Any] = {}
    regressions: List[str] = []
    for leg in selected:
        b, c = baseline.get(leg), current.get(leg)
        if not isinstance(c, dict) or not isinstance(b, dict):
            where = "current" if not isinstance(c, dict) else "baseline"
            if required:
                out_legs[leg] = {
                    "status": "regression",
                    "note": f"required leg missing in {where}",
                }
                regressions.append(leg)
            else:
                out_legs[leg] = {
                    "status": "skipped", "note": f"missing in {where}",
                }
            continue
        result = compare_leg(b, c, tolerance, min_seconds, timings_comparable)
        out_legs[leg] = result
        if result["status"] == "regression":
            regressions.append(leg)
    return {
        "ok": not regressions,
        "regressions": regressions,
        "timings_comparable": timings_comparable,
        "baseline_platform": base_platform,
        "current_platform": cur_platform,
        "tolerance": tolerance,
        "legs": out_legs,
    }


# ----------------------------------------------------------------------- CLI


def add_bench_diff_arguments(parser: argparse.ArgumentParser) -> None:
    """Flags for ``bench-diff`` (plain argparse — the CLI's --help path
    imports no torch)."""
    parser.add_argument(
        "--baseline", required=True,
        help="previous BENCH_*.json artifact (driver wrapper or raw report)",
    )
    parser.add_argument(
        "--current", required=True,
        help="fresh BENCH json (raw report or BENCH_CHILD_JSON payload)",
    )
    parser.add_argument(
        "--legs", default=None,
        help="comma-separated legs to compare (default: every shared leg)",
    )
    parser.add_argument(
        "--tolerance", type=float, default=0.5,
        help="relative timing tolerance before a slowdown counts "
             "(default 0.5 = +50%%, wide enough for CI noise)",
    )
    parser.add_argument(
        "--min-seconds", type=float, default=0.05,
        help="absolute timing floor: deltas below this never regress "
             "(default 0.05 s)",
    )
    parser.add_argument(
        "--out", default=None, help="also write the verdict JSON here",
    )


def bench_diff_from_args(args: argparse.Namespace) -> int:
    baseline = load_bench_report(args.baseline)
    current = load_bench_report(args.current)
    legs = [l.strip() for l in args.legs.split(",") if l.strip()] if args.legs else None
    verdict = diff_reports(
        baseline, current, legs=legs,
        tolerance=args.tolerance, min_seconds=args.min_seconds,
    )
    for leg, result in sorted(verdict["legs"].items()):
        line = f"{leg:24s} {result['status']}"
        if result.get("note"):
            line += f" ({result['note']})"
        bad = [c for c in result.get("checks", ())
               if c["verdict"] == "regression"]
        for c in bad:
            line += f"\n{'':24s}   {c['key']}: {c['base']} -> {c['current']}"
        print(line)
    if not verdict["timings_comparable"]:
        print(
            f"note: timings not compared (baseline platform "
            f"{verdict['baseline_platform']!r} != current "
            f"{verdict['current_platform']!r}); counts still exact"
        )
    print("BENCH_DIFF_JSON:" + json.dumps(verdict))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=1)
    if verdict["ok"]:
        print("bench-diff: OK")
        return 0
    print(f"bench-diff: PERF REGRESSION in {verdict['regressions']}")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="bench_diff",
        description="compare two BENCH json artifacts; exit 1 on regression",
    )
    add_bench_diff_arguments(parser)
    return bench_diff_from_args(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
