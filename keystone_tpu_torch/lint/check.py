"""``python -m keystone_tpu_torch check`` — the static-tier CLI.

Port of ``keystone_tpu/lint/check.py``. Three halves, composable in one
invocation:

``--lint [PATH ...]``
    Run keystone-lint (``lint/rules.py``, stdlib ``ast``) over source
    trees (default: the ``keystone_tpu_torch`` package). Any finding
    fails the run; ``tests/test_torch_lint.py`` keeps the port's tree
    clean.

``--concurrency [PATH ...]``
    Run the concurrency tier (``lint/concurrency.py`` over the
    ``lint/lockmodel.py`` lock model): KV6xx findings plus the full
    acquired-while-holding lock graph in ``--json`` output (the
    lock-witness baseline is generated from it). Stdlib only like
    ``--lint``; the JSON carries ``torch_free`` (the JAX package's
    ``jax_free``) so a caller can assert no backend was imported for a
    pure static pass.

``--pipeline PATH|synthetic``
    Plan-time graph verification (``workflow/verify.py``) of a saved
    ``FittedPipeline.save`` artifact — or the synthetic serving chain —
    with an optional bound ``--input-spec``. Pure spec propagation: the
    artifact's tensors are read onto the host (the verifier needs their
    shapes, not their values) and the plan is verified for ``--device``
    (default the CUDA device; its memory is the budget). The JSON reports
    what the pass did on the card in place of the JAX package's
    ``xla_compiles``: ``device_counts`` with the ELL kernel's launches,
    the cuBLAS binding's calls and the change in
    ``torch.cuda.memory_allocated()`` — all three 0 — and
    ``shape_rule_fallbacks``, the torch ops no shape rule of
    ``workflow/shape_rules.py`` answered (each one makes the process
    import torch's Python ``meta`` kernels). ``--seed-mismatch``
    deliberately mis-sizes the input spec (the negative control: a
    verifier that stops flagging a planted KV101 fails, not a user).

Exit code 0 iff zero lint findings and zero error-severity diagnostics
(warnings don't fail — the same contract as ``KEYSTONE_VERIFY=warn``);
2 when there is nothing to do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def add_check_arguments(parser: argparse.ArgumentParser) -> None:
    """Stdlib-only flag wiring — ``check --help`` imports no torch."""
    parser.add_argument(
        "--lint",
        nargs="*",
        metavar="PATH",
        default=None,
        help="lint source trees (no PATH: the keystone_tpu_torch package)",
    )
    parser.add_argument(
        "--concurrency",
        nargs="*",
        metavar="PATH",
        default=None,
        help="concurrency analysis: KV6xx lock-discipline/deadlock-order "
        "findings + the lock-order graph (no PATH: the keystone_tpu_torch package)",
    )
    parser.add_argument(
        "--pipeline",
        metavar="PATH|synthetic",
        default=None,
        help="verify a FittedPipeline.save artifact, or 'synthetic'",
    )
    parser.add_argument(
        "--input-spec",
        metavar="ROWSxCOLS:DTYPE",
        default=None,
        help="bind the pipeline input spec, e.g. 16x64:float32 "
        "(default for synthetic: 16x64:float32)",
    )
    parser.add_argument(
        "--buckets",
        default=None,
        help="comma-separated serving batch buckets the plan will pad onto",
    )
    parser.add_argument(
        "--warmed-buckets",
        default=None,
        help="comma-separated buckets the warmup covers "
        "(utils/aot.warm_buckets); missing buckets are KV301 errors",
    )
    parser.add_argument(
        "--seed-mismatch",
        action="store_true",
        help="deliberately mis-size the input spec (negative control)",
    )
    parser.add_argument(
        "--store",
        action="store_true",
        dest="store_report",
        help="report the profile store's provenance: entries by source "
        "(observed vs tune) and the tuner-written keys",
    )
    parser.add_argument(
        "--device",
        default=None,
        help="device the --pipeline plan is verified for (default: the CUDA "
        "device, whose memory is the budget; 'cpu' for none)",
    )
    parser.add_argument("--json", action="store_true", dest="as_json", help="JSON output")


def _parse_spec(text: str) -> Any:
    """``16x64:float32`` → a ``meta`` tensor of that shape and dtype."""
    from ..workflow.verify import spec_leaf

    shape_part, _, dtype_part = text.partition(":")
    shape = tuple(int(p) for p in shape_part.split("x") if p)
    return spec_leaf(shape, dtype_part or "float32")


def _parse_buckets(text: Optional[str]) -> Optional[List[int]]:
    if not text:
        return None
    return [int(p) for p in text.split(",") if p.strip()]


def _device_counts() -> Dict[str, int]:
    """The card-side counters a pure verification must leave alone."""
    import torch

    from ..ops.cuda import blocksparse, gemm

    return {
        "ell_launches": int(blocksparse.ell_matmul.launches),
        "binding_calls": int(sum(gemm.launches.values())),
        "memory_allocated": int(torch.cuda.memory_allocated()) if torch.cuda.is_available() else 0,
    }


def _store_report(out: Dict[str, Any], human: List[str]) -> None:
    """Profile-store provenance: which decisions were actively searched
    (source=tune) vs passively replayed (source=observed). A pure store
    read."""
    from ..obs import store as _store
    from ..obs.store import is_stale

    store = _store.get_store()
    if store is None:
        out["store"] = {"enabled": False}
        human.append("store: disabled (KEYSTONE_PROFILE_STORE=off)")
        return
    entries = list(store.entries(any_env=True, include_stale=True))
    by_source = store.by_source()
    tuned_keys = sorted({key for key, _shape, m in entries if m.get("source") == "tune"})
    # Drift-marked entries (obs/cost.py sentinel): still stored for
    # post-hoc inspection, no longer replayed by any rule.
    stale_keys = sorted({key for key, _shape, m in entries if is_stale(m)})
    out["store"] = {
        "enabled": True,
        **store.stats(),
        "by_source": by_source,
        "tuned_keys": tuned_keys,
        "stale_keys": stale_keys,
    }
    human.append(
        f"store[{store.path}]: {len(store)} entries, by source {by_source or '{}'}, "
        f"{len(tuned_keys)} tuned keys, {len(stale_keys)} stale"
    )
    human += ["  tuned: " + k for k in tuned_keys[:20]]
    human += ["  stale: " + k for k in stale_keys[:20]]


def _pipeline_report(args: argparse.Namespace, out: Dict[str, Any], human: List[str]) -> bool:
    import torch

    from ..device import resolve_device
    from ..workflow.shape_rules import FALLBACKS
    from ..workflow.verify import _device_memory_limit, spec_leaf, verify_pipeline

    device = resolve_device(args.device)
    before = _device_counts()
    if args.pipeline == "synthetic":
        from ..serving.synthetic import synthetic_chain_pipeline

        pipeline = synthetic_chain_pipeline(num_nodes=4, d=64, device="cpu")
        spec_text = args.input_spec or "16x64:float32"
    else:
        from ..workflow.pipeline import FittedPipeline

        pipeline = FittedPipeline.load(args.pipeline, device="cpu").fused()
        spec_text = args.input_spec
    input_spec = _parse_spec(spec_text) if spec_text else None
    if args.seed_mismatch and input_spec is not None:
        # Chop the trailing width: every downstream product/projection
        # must reject it — the planted KV101.
        shape = tuple(input_spec.shape)
        input_spec = spec_leaf(shape[:-1] + (max(1, shape[-1] - 1),), input_spec.dtype)
    memory = (
        _device_memory_limit(None) if device.type == "cuda" and torch.cuda.is_available() else None
    )
    report = verify_pipeline(
        pipeline,
        input_spec,
        buckets=_parse_buckets(args.buckets),
        warmed_buckets=_parse_buckets(args.warmed_buckets),
        device_memory_bytes=memory,
        probe_objects=True,
        context=f"check:{args.pipeline}",
    )
    after = _device_counts()
    counts = {
        "ell_launches": after["ell_launches"] - before["ell_launches"],
        "binding_calls": after["binding_calls"] - before["binding_calls"],
        "memory_allocated_delta": after["memory_allocated"] - before["memory_allocated"],
    }
    out["pipeline"] = report.to_json()
    out["device"] = str(device)
    out["device_memory_bytes"] = memory
    out["device_counts"] = counts
    # The ops no shape rule answered (workflow/shape_rules.py), and
    # whether this process imported torch's symbolic-shape machinery.
    out["shape_rule_fallbacks"] = dict(FALLBACKS)
    out["symbolic_shapes_imported"] = "torch.fx.experimental.symbolic_shapes" in sys.modules
    human.append(report.render())
    human.append(f"device_counts: {counts}")
    return report.ok


def check_from_args(args: argparse.Namespace) -> int:
    from . import lint_paths

    out: Dict[str, Any] = {}
    human: List[str] = []
    ok = True

    if (
        args.lint is None
        and args.pipeline is None
        and args.concurrency is None
        and not getattr(args, "store_report", False)
    ):
        print("check: nothing to do (pass --lint, --concurrency, --pipeline, and/or --store)")
        return 2

    if getattr(args, "store_report", False):
        _store_report(out, human)

    if args.lint is not None:
        paths = list(args.lint) or [_package_root()]
        findings = lint_paths(paths)
        out["lint"] = {"paths": paths, "findings": [f.to_json() for f in findings], "ok": not findings}
        human.append(f"lint[{', '.join(paths)}]: {len(findings)} findings")
        human += ["  " + f.render() for f in findings]
        ok = ok and not findings

    if args.concurrency is not None:
        from .concurrency import analyze_paths as analyze_concurrency

        paths = list(args.concurrency) or [_package_root()]
        t0 = time.perf_counter()
        findings, model = analyze_concurrency(paths)
        seconds = time.perf_counter() - t0
        out["concurrency"] = {
            "paths": paths,
            "findings": [f.to_json() for f in findings],
            "lock_graph": model.to_json(),
            "seconds": round(seconds, 4),
            # Pure static pass: no backend was imported for it.
            "torch_free": sys.modules.get("torch") is None and sys.modules.get("jax") is None,
            "ok": not findings,
        }
        human.append(
            f"concurrency[{', '.join(paths)}]: {len(findings)} findings, "
            f"{len(model.locks)} locks, {len(model.edges)} order edges, "
            f"{seconds * 1e3:.0f} ms"
        )
        human += ["  " + f.render() for f in findings]
        ok = ok and not findings

    if args.pipeline is not None:
        ok = _pipeline_report(args, out, human) and ok

    out["ok"] = ok
    if args.as_json:
        print(json.dumps(out))
    else:
        print("\n".join(human))
        print("check: OK" if ok else "check: FAILED")
    return 0 if ok else 1
