"""``python -m keystone_tpu_torch explain`` — the "why is this pipeline
slow" report.

Port of ``keystone_tpu/workflow/explain.py``. Runs a pipeline's optimized
plan under the cost observatory (``obs/cost.py``) and prints it node by
node: decision provenance (which rule drove the node — autocache
profile, measured-knob winner, solver ladder rung — and which stored
entry), predicted cost vs measured wall, achieved FLOP/s and bytes/s,
arithmetic intensity, and placement against the card's probed roofline
at the product kind each launch ran at. The drift sentinel runs live: a
stored cost model that no longer matches reality fires a ``cost_drift``
event, marks the entry ``stale:``, and the report says so.

Execution shape: the same plan is fitted ``--passes`` times (default 3)
with the pipeline state reset between passes. A node during which nvcc
built a kernel library or cuFFT created a plan is marked ``cold`` and
never drift-scores; later passes measure steady state. The report is
built from the LAST pass's ledger window. ``harvest_compiles`` counts
kernel builds the accounting itself caused and must be 0 (facts come
from launch sites; nothing is built for them).

Pipelines (``--pipeline``):

- ``synthetic`` — a small featurize → fit chain (SyntheticDense ×2 →
  BlockLeastSquaresEstimator) under the auto-caching optimizer, so every
  decision layer is exercised (the JAX package's);
- ``hashing-tf`` — the hashing-TF → block-sparse least-squares slice:
  ``--rows`` topic documents hashed to ``--dim`` features, fitted through
  the ELL kernel (2 launches a fit with ``KEYSTONE_BLOCKSPARSE_BLOCK=16x16``);
- ``mnist`` — the MNIST random-FFT pipeline (784 → ``--num-ffts`` ×
  2,048 → 10) on ``--rows`` synthetic rows. The auto-cache planner fits
  the estimator on 128- and 512-row samples, where 8,192 features leave
  every block Gram singular: the port's Cholesky raises (the JAX
  package's returns NaN), the planner logs that it gives up, and the
  plan runs uncached, its nodes priced by the roofline alone;
- a path — a ``FittedPipeline.save`` artifact, whose (re-fused) apply
  path is explained instead.

``--seed-drift F`` corrupts the stored autocache measurements by ``F``×
once the sentinel has an in-process baseline — the negative control: the
sentinel must flag exactly the seeded corruption (exit 2).

Flag wiring lives in ``cli.py`` (``--help`` imports no torch); this
module imports torch transitively and is loaded only at dispatch.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------- pipelines


def _synthetic_fit_pipeline(rows: int, dim: int, classes: int, seed: int, device):
    """data → SyntheticDense ×2 → BlockLeastSquaresEstimator, plus the
    bound eval apply: one pipeline exercising the auto-cache profiler
    (the block estimator's weight makes the featurized node a cache
    candidate), fusion, the streaming planner (when ``rows`` clears the
    chunk floor) and measured knobs. The draws are the JAX package's."""
    import numpy as np
    import torch

    from ..data.dataset import ArrayDataset
    from ..ops.learning.block import BlockLeastSquaresEstimator
    from ..serving.synthetic import SyntheticDense

    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(dim)
    w1 = (rng.standard_normal((dim, dim)) * scale).astype(np.float32)
    w2 = (rng.standard_normal((dim, dim)) * scale).astype(np.float32)
    x = rng.standard_normal((rows, dim)).astype(np.float32)
    w_true = rng.standard_normal((dim, classes)).astype(np.float32)
    y = (np.tanh(x @ w1) @ w_true + 0.01 * rng.standard_normal((rows, classes))).astype(np.float32)

    def on(a):
        return torch.from_numpy(a).to(device)

    feat = SyntheticDense([on(w1)]).to_pipeline().then(SyntheticDense([on(w2)]))
    est = BlockLeastSquaresEstimator(min(64, dim), num_iter=2, reg=1e-3, device=device)
    pipe = feat.then_label_estimator(est, ArrayDataset(x, device=device), ArrayDataset(y, device=device))
    x_eval = ArrayDataset(x[: min(256, rows)], device=device)
    return pipe, x_eval


def topic_corpus(docs: int, seed: int, classes: int, docs_per_topic: int = 64, vocab_per_topic: int = 12):
    """Topic-grouped documents of 5–14 tokens from a per-topic
    vocabulary (the block-sparse bench's generator, ``RandomState``),
    joined into strings; label = topic % ``classes``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    texts, labels = [], []
    for topic in range(max(1, docs // docs_per_topic)):
        vocab = [f"t{topic}w{j}" for j in range(vocab_per_topic)]
        for _ in range(docs_per_topic):
            length = 5 + int(rng.randint(0, 10))
            texts.append(" ".join(vocab[int(rng.randint(0, vocab_per_topic))] for _ in range(length)))
            labels.append(topic % classes)
    return texts, np.asarray(labels, np.int32)


def _hashing_tf_pipeline(rows: int, dim: int, classes: int, seed: int, device):
    """Hashed topic documents → BlockLeastSquaresEstimator fitted on the
    sparse rows (the block-sparse path through the ELL kernel when the
    tiles are sparse enough), applied to densified eval rows."""
    from ..data.dataset import ArrayDataset, ObjectDataset
    from ..ops.learning.block import BlockLeastSquaresEstimator
    from ..ops.nlp.text import HashingTF, LowerCase, Tokenizer, Trim
    from ..ops.util.labels import ClassLabelIndicators
    from ..ops.util.vectors import Densify

    texts, labels = topic_corpus(rows, seed, classes)
    feat = Trim().to_pipeline().then(LowerCase()).then(Tokenizer()).then(HashingTF(dim))
    y = ClassLabelIndicators(classes)(ArrayDataset(labels, device=device)).get()
    est = BlockLeastSquaresEstimator(4096, num_iter=1, reg=1e-3, device=device)
    fitted_head = est.with_data(feat.apply(ObjectDataset(texts)), y)
    pipe = feat.then(Densify(device=device)).then(fitted_head)
    x_eval = ObjectDataset(texts[: min(256, len(texts))])
    return pipe, x_eval


def _mnist_pipeline(rows: int, num_ffts: int, seed: int, device):
    from ..pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline, synthetic_mnist

    config = MnistRandomFFTConfig(num_ffts=num_ffts, seed=seed)
    train = synthetic_mnist(rows, seed=seed, device=device)
    test = synthetic_mnist(min(rows, 1024), seed=seed + 1, device=device)
    return build_pipeline(config, train, device=device), test.data


def _corrupt_store_predictions(factor: float) -> int:
    """The seeded mis-prediction: scale ONE autocache entry's
    coefficients AND its measured baseline by ``1/factor`` (the entry
    with the largest measured baseline), so "exactly one drift event" is
    assertable. Returns the number of entries corrupted (0 or 1)."""
    from ..obs import store as _store
    from ..obs.cost import DriftSentinel

    store = _store.get_store()
    if store is None or factor in (0, 1):
        return 0
    baseline_field = DriftSentinel.BASELINE_FIELD
    candidates = [
        (float(m.get(baseline_field, 0.0) or 0.0), key, shape, m)
        for key, shape, m in store.entries(key_prefix="autocache:", include_stale=True)
        if not _store.is_stale(m)
    ]
    if not candidates:
        return 0
    _, key, shape, m = max(candidates, key=lambda c: (c[0], c[1]))
    m2 = dict(m)
    for field in ("t0", "t1", "run_time_s", baseline_field):
        if isinstance(m2.get(field), (int, float)):
            m2[field] = float(m2[field]) / factor
    store.record(key, shape, **m2)
    return 1


# --------------------------------------------------------------------- passes


def _explain_optimizer():
    """The auto-caching stack with explain-grade profiling scales: the
    default (2, 4)-item samples are fine for RELATIVE cache decisions and
    useless as absolute predictions; a few hundred rows cost milliseconds
    and give extrapolations worth printing next to measured walls."""
    from .autocache import AutoCacheRule
    from .rules import auto_caching_optimizer

    stack = auto_caching_optimizer()
    for batch in stack.batches:
        for i, rule in enumerate(batch.rules):
            if isinstance(rule, AutoCacheRule):
                batch.rules[i] = AutoCacheRule(profile_scales=(128, 512))
    return stack


def _run_pass(pipe, x_eval, optimizer_factory):
    """One optimize+fit+apply execution in a fresh pipeline env under a
    synced tracing session; returns (ledger entries, executor)."""
    from ..obs import cost as _cost
    from ..obs import spans as _spans
    from .executor import PipelineEnv

    PipelineEnv.reset()
    PipelineEnv.get_or_create().optimizer = optimizer_factory()
    _cost.reset_plan_predictions()
    cursor = _cost.get_ledger().cursor()
    with _spans.tracing_session("explain", sync_timings=True):
        with _spans.span("explain:pass"):
            handle = pipe.apply(x_eval)
            handle.get()
    return _cost.get_ledger().entries(cursor), handle._executor


def _provenance(entry, partition_by_label: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The decision trail for one node: which model/rule claimed it and
    from which stored entry, the whole ladder an argmin saw, the
    partitioner's recorded decision when one names the node, and the
    launch sites it ran."""
    out: Dict[str, Any] = {}
    if entry.predicted_model:
        out["model"] = entry.predicted_model
        if entry.predicted_key:
            out["store_key"] = entry.predicted_key
        if entry.predicted_shape:
            out["shape_class"] = entry.predicted_shape
    if getattr(entry, "predicted_candidates", ()):
        out["candidates"] = [
            {"rung": name, "predicted_s": cost, "reason": reason}
            for name, cost, reason in entry.predicted_candidates
        ]
    decision = (partition_by_label or {}).get(entry.node)
    if decision is not None:
        out["partition"] = {
            "eligible": bool(decision.eligible),
            "reason": str(decision.reason),
            "shards": int(decision.shards or 1),
        }
    if entry.kinds:
        out["computations"] = list(entry.kinds)
    return out


def _render_human(report: Dict[str, Any]) -> str:
    lines = [
        f"explain: {report['pipeline']} — pass {report['passes']} of "
        f"{report['passes']} (steady state), roofline "
        f"{report['roofline']['backend'] if report.get('roofline') else '?'}"
    ]
    if report.get("roofline"):
        r = report["roofline"]
        kinds = ", ".join(
            f"{k} {v / 1e12:.1f}" for k, v in sorted(r.get("peak_flops_by_kind", {}).items())
        )
        lines.append(
            f"  roofline[{r['source']}]: TFLOP/s {kinds or r['peak_flops_per_s'] / 1e12}, "
            f"{r['peak_bytes_per_s'] / 1e9:.1f} GB/s, "
            f"ridge {r['ridge_intensity']:.2f} flop/byte (fp32)"
        )
    lines.append(
        f"  {'node':40s} {'wall ms':>9s} {'pred ms':>9s} "
        f"{'GFLOP/s':>8s} {'int.':>6s} {'share':>6s} {'bound':>14s}  provenance"
    )
    nan = float("nan")
    for node in report["nodes"]:
        wall = node.get("seconds", 0.0) * 1e3
        pred = node.get("predicted_s")
        gflops = node.get("flops_per_s")
        intensity = node.get("intensity")
        share = node.get("bound_frac")
        prov = node.get("provenance", {})
        prov_text = prov.get("model", "-")
        if prov.get("store_key"):
            prov_text += f" ← {prov['store_key'][:40]}"
        if node.get("drift"):
            prov_text += "  ** DRIFT **"
        lines.append(
            f"  {node['node'][:40]:40s} {wall:9.3f} "
            f"{(pred * 1e3 if pred is not None else nan):9.3f} "
            f"{(gflops / 1e9 if gflops else nan):8.2f} "
            f"{(intensity if intensity is not None else nan):6.2f} "
            f"{(share if share is not None else nan):6.3f} "
            f"{node.get('roofline') or 'unmeasured':>14s}  {prov_text}"
        )
        for cand in prov.get("candidates", []):
            cost = cand.get("predicted_s")
            cost_text = f"{cost * 1e3:9.3f}" if cost is not None else "      inf"
            lines.append(f"    ∟ rung {cand['rung']:14s} pred ms {cost_text}  {cand['reason']}")
    for event in report.get("drift_events", []):
        lines.append(
            f"  DRIFT: {event['model']} mis-predicted {event['node']} "
            f"(ratio {event['ratio']}, key {event['key']}"
            f"{', marked stale' if event.get('stale_marked') else ''})"
        )
    lines.append(
        f"  harvest_compiles={report['harvest_compiles']} "
        f"stale_entries={report['store']['stale_entries']} "
        f"drift_events={len(report.get('drift_events', []))}"
    )
    return "\n".join(lines)


def _render_schedule(evidence: Dict[str, Any]) -> str:
    """The card's schedule, human-readable: one row per lease — who ran,
    its outcome, what displaced it, predicted vs measured wall and the
    price's provenance rung."""
    lines = [
        "explain --schedule",
        f"  serial wall {evidence['serial_wall_s']:.3f}s vs co-scheduled "
        f"{evidence['cosched_wall_s']:.3f}s "
        f"(ratio {evidence['cosched_vs_serial_ratio']}), "
        f"p99 {evidence['p99_ms_worst']:.1f}ms / "
        f"target {evidence['slo_target_ms']:.0f}ms, "
        f"dropped {evidence['dropped']}, "
        f"idle harvested {evidence['idle_harvest_s']:.3f}s",
        f"  {'lease':14s} {'work':24s} {'kind':10s} {'outcome':10s} "
        f"{'rows':>6s} {'price':>9s} {'pred ms':>9s} {'meas ms':>9s} "
        f"{'ratio':>6s}  displaced by",
    ]
    nan = float("nan")
    for entry in evidence.get("obs", {}).get("schedule", []):
        pred = entry.get("predicted_s")
        meas = entry.get("measured_s")
        ratio = entry.get("ratio")
        displaced = entry.get("displaced_by") or "-"
        if entry.get("preempted_at_chunk") is not None:
            displaced += f" (preempted at chunk {entry['preempted_at_chunk']})"
        if entry.get("resume_of"):
            displaced += f" (resumes {entry['resume_of']})"
        lines.append(
            f"  {entry['lease']:14s} {entry['name'][:24]:24s} "
            f"{entry['kind']:10s} {entry['outcome']:10s} "
            f"{entry['rows']:>6d} {entry['price'].get('source', '-'):>9s} "
            f"{(pred * 1e3 if pred is not None else nan):9.3f} "
            f"{(meas * 1e3 if meas is not None else nan):9.3f} "
            f"{(ratio if ratio is not None else nan):6.2f}  "
            f"{displaced}"
        )
    lines.append(
        f"  leases={evidence['leases']} "
        f"preemptions={evidence['preemptions']} "
        f"publishes={evidence['publishes']} "
        f"parity_max_abs_diff={evidence['parity_max_abs_diff']:.2e}"
    )
    return "\n".join(lines)


def _explain_schedule(args: argparse.Namespace) -> int:
    """``explain --schedule``: run the co-scheduled demo and print who got
    the card, what was displaced or deferred, and predicted vs measured
    wall per lease."""
    from ..sched.demo import CoschedDemoConfig, run_cosched_demo

    evidence = run_cosched_demo(CoschedDemoConfig(seed=args.seed), device=args.device)
    body = json.dumps(evidence)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body)
    if args.as_json:
        print("SCHED_JSON:" + body)
    else:
        print(_render_schedule(evidence))
    ok = evidence["dropped"] == 0 and evidence["parity_ok"] and evidence["p99_within_slo"]
    return 0 if ok else 2


def explain_from_args(args: argparse.Namespace) -> int:
    from ..obs import cost as _cost

    if getattr(args, "schedule", False):
        return _explain_schedule(args)

    override_before = _cost._enabled_override
    _cost.set_cost_observatory(True)
    _cost.record_all_nodes(True)
    try:
        return _explain(args)
    finally:
        # Embedders calling this in-process get their observatory state
        # back; the CLI process just exits.
        _cost.set_cost_observatory(override_before)
        _cost.record_all_nodes(False)


def build_explain_pipeline(args: argparse.Namespace, device):
    """(pipeline, eval data) for ``--pipeline`` (module docstring)."""
    if args.pipeline == "synthetic":
        return _synthetic_fit_pipeline(args.rows, args.dim, args.classes, args.seed, device)
    if args.pipeline == "hashing-tf":
        return _hashing_tf_pipeline(args.rows, args.dim, args.classes, args.seed, device)
    if args.pipeline == "mnist":
        return _mnist_pipeline(args.rows, args.num_ffts, args.seed, device)
    import numpy as np

    from ..data.dataset import ArrayDataset
    from .pipeline import FittedPipeline

    fitted = FittedPipeline.load(args.pipeline, device=device).fused()
    rng = np.random.default_rng(args.seed)
    return fitted, ArrayDataset(rng.standard_normal((256, args.dim)).astype(np.float32), device=device)


def _explain(args: argparse.Namespace) -> int:
    from ..device import resolve_device
    from ..obs import cost as _cost
    from ..obs import names as _names
    from ..obs import store as _store
    from ..obs.metrics import get_registry

    device = resolve_device(args.device)
    # Roofline first: the probe's products are calibration, never
    # attributable to a node.
    roofline = _cost.get_roofline(device=device)
    pipe, x_eval = build_explain_pipeline(args, device)

    seed_factor = args.seed_drift if args.seed_drift and args.seed_drift != 1.0 else 0
    seeded = 0

    registry = get_registry()
    harvest_before = registry.snapshot().get(_names.COST_HARVEST_COMPILES, 0)
    drift_before = list(_cost.get_drift_sentinel().events)

    entries: List[Any] = []
    total_passes = max(1, args.passes)
    index = 0
    while index < total_passes:
        entries, executor = _run_pass(pipe, x_eval, _explain_optimizer)
        index += 1
        if seed_factor and not seeded and _cost.get_drift_sentinel().seen_count():
            # Corrupt only once the sentinel has re-based baselines to
            # THIS process's walls, then guarantee enough further passes
            # for the sustain threshold to fire.
            seeded = _corrupt_store_predictions(seed_factor)
            total_passes = max(total_passes, index + _cost.drift_sustain())

    drift_events = [e for e in _cost.get_drift_sentinel().events if e not in drift_before]
    harvest_compiles = int(registry.snapshot().get(_names.COST_HARVEST_COMPILES, 0) - harvest_before)

    store = _store.get_store()
    stale_keys: List[str] = []
    if store is not None:
        stale_keys = sorted(
            {
                key
                for key, _shape, m in store.entries(any_env=True, include_stale=True)
                if _store.is_stale(m)
            }
        )

    # The plan's partition decisions, by the node label they name.
    partition_by_label = {str(d.node): d for d in executor.partition_decisions if d.node}
    nodes = []
    for entry in entries:
        node = entry.to_json()
        node["provenance"] = _provenance(entry, partition_by_label)
        nodes.append(node)

    report: Dict[str, Any] = {
        "pipeline": args.pipeline,
        "device": str(device),
        "passes": index,
        "roofline": roofline.to_json() if roofline else None,
        "nodes": nodes,
        "drift_events": drift_events,
        "seeded_corruptions": seeded,
        "harvest_compiles": harvest_compiles,
        "store": {
            "enabled": store is not None,
            "stale_entries": len(stale_keys),
            "stale_keys": stale_keys,
        },
    }
    body = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body)
    if args.as_json:
        print("EXPLAIN_JSON:" + body)
    else:
        print(_render_human(report))
    # Exit code mirrors the sentinel: a run that caught live drift fails
    # a step that expected a quiet model.
    return 2 if drift_events else 0
