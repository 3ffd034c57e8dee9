"""In-process model server: threaded front-end over the micro-batcher.

Port of ``keystone_tpu/serving/server.py``'s single-process server. One
worker thread assembles micro-batches, pads them to the nearest shape
bucket (so the apply path runs at a small fixed set of batch shapes that
warmup has already met), applies the resolved model version under the
configured RetryPolicy, and distributes per-row results to request
futures. ``submit``/``submit_many`` are plain Python — no network stack;
``python -m keystone_tpu_torch serve`` drives the same API over
stdin/stdout JSON lines.

Request lifecycle:

    submit → admission (shed?) → bounded queue → batch assembly
           → stack on the host, pad to bucket → one copy to the device
           → resolve model version → retrying apply
           → one copy of the output to the host → slice rows there
           → future.set_result

The server runs on ``device`` (default CUDA; ``"cpu"`` only when asked).
Where the JAX server reports ``xla_compiles_since_warmup``, this one
reports ``cufft_plans_since_warmup`` on the card: the growth of cuFFT's
plan cache since ``warmup()``, which must stay 0 in steady state.

Refit traffic tap: ``PipelineServer(..., tap=...)`` offers each batch's
payloads to a :class:`~keystone_tpu_torch.refit.tap.TrafficTap` after
every future of the batch has settled; a failure in the tap is logged
and never fails a request.

``serve`` with ``--workers > 1``, ``--listen``, ``--slo-p99-ms``,
``--boot-image`` or ``--autoscale`` runs the supervised multi-worker
runtime instead (:func:`~keystone_tpu_torch.serving.frontend.
serve_multiworker_from_args`). torch is imported where a server is
built, not with this module: ``serve --help`` and the fleet's front-end
process import none of it.

Left out for now: the serving partition.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from concurrent.futures import Future
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

import numpy as np

from ..obs import spans as _spans
from ..ops.cuda import device_counts
from ..reliability.faultinject import probe
from ..reliability.retry import Deadline, RetryPolicy
from ..utils.tree import tree_leaves, tree_map, tree_structure
from .admission import AdmissionController
from .batcher import MicroBatcher
from .config import (
    Request,
    RequestShed,
    RequestTimeout,
    ServerClosed,
    ServingConfig,
    ServingError,
    bucket_for,
    parse_stdin_request,
    settle_exception as _settle_exception,
    settle_result as _settle_result,
)
from .registry import ModelEntry, ModelRegistry
from .telemetry import ServingTelemetry

if TYPE_CHECKING:
    from ..device import DeviceLike

logger = logging.getLogger("keystone_tpu_torch.serving")


class PipelineServer:
    """Micro-batched inference server over a :class:`ModelRegistry`."""

    def __init__(
        self,
        model: Any = None,
        config: ServingConfig = None,
        registry: Optional[ModelRegistry] = None,
        name: str = "default",
        telemetry: Optional[ServingTelemetry] = None,
        device: DeviceLike = None,
        tap: Any = None,
    ):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.config = config or ServingConfig()
        self.registry = registry or ModelRegistry()
        if model is not None:
            self.registry.publish(name, model)
        self.default_model = name
        #: Opt-in refit traffic tap (refit/tap.py): settled request
        #: payloads are sampled into its bounded mirror buffer after each
        #: batch — off the submit path, and a full or slow tap only ever
        #: drops tap rows, never requests.
        self.tap = tap
        self.telemetry = telemetry or ServingTelemetry(
            window=self.config.telemetry_window, default_model=self.default_model
        )
        self.admission = AdmissionController(self.config.queue_depth)
        self.batcher = MicroBatcher(
            self.config.queue_depth,
            on_expired=lambda req: self.telemetry.record_timeout(model=req.model),
        )
        self._buckets = self.config.buckets()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._accepting = False
        self._plan_baseline: Optional[int] = None

    # ---------------------------------------------------------------- control
    def start(self) -> "PipelineServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()  # restartable: a stop()ed server can start() again
        self._accepting = True
        self._thread = threading.Thread(
            target=self._worker, name="keystone-serving-worker", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop accepting; by default finish everything queued first."""
        self._accepting = False
        if not drain:
            self.batcher.fail_all(ServerClosed())
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            if self._thread.is_alive():
                # Worker still draining past the timeout: keep the handle
                # so a premature start() raises instead of spawning a
                # second worker against the same queue.
                logger.warning(
                    "serving worker still draining after %.0fs; "
                    "server is not restartable until it exits", timeout_s,
                )
                return
            self._thread = None

    def __enter__(self) -> "PipelineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------------- warmup
    def warmup(self, example: Any, models: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """Drive every shape bucket through each model's apply path on the
        server's device, so no request size meets a cold batch shape at
        serve time. ``example`` is one request payload (array, tensor or
        a tuple/list/dict of them). Returns per-model ``bucket_<n>_s``
        seconds, plus one sibling ``"partition_decisions"`` entry mapping
        each model to its serving partition decision (the per-model dicts
        stay pure timings), and stamps the cuFFT plan-cache baseline for
        ``stats()``."""
        from ..parallel.partitioner import attach_serving_partition
        from ..utils.aot import warm_buckets

        out: Dict[str, Any] = {}
        for model_name in models or self.registry.names():
            entry = self.registry.resolve(model_name)
            # Decide the row sharding BEFORE warming, so the warmed
            # batches take the layouts steady state replays.
            decision = attach_serving_partition(entry.model, self._buckets, name=model_name)
            out[model_name] = warm_buckets(
                entry.batch_apply, example, self._buckets, device=self.device
            )
            if decision is not None:
                out.setdefault("partition_decisions", {})[model_name] = decision.to_json()
        for bucket in self._buckets:
            self.telemetry.mark_bucket_warm(bucket)
        self._plan_baseline = self._cufft_plans()
        return out

    def _cufft_plans(self) -> Optional[int]:
        """Plans in cuFFT's plan cache of the server's card (None on the
        CPU): one per FFT shape met so far in this process."""
        if self.device.type != "cuda":
            return None
        import torch

        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        return torch.backends.cuda.cufft_plan_cache[index].size

    # ----------------------------------------------------------------- submit
    def submit(
        self,
        payload: Any,
        deadline_s: Optional[float] = None,
        model: Optional[str] = None,
    ) -> Future:
        """Enqueue one request; returns its Future. Raises
        :class:`RequestShed` under overload and :class:`ServerClosed`
        after stop() — backpressure is synchronous and loud."""
        if not self._accepting:
            raise ServerClosed()
        deadline = None
        seconds = deadline_s if deadline_s is not None else self.config.default_deadline_s
        if seconds is not None:
            deadline = Deadline(seconds)
        try:
            self.admission.admit(self.batcher.depth())
        except RequestShed:
            self.telemetry.record_shed(model=model or self.default_model)
            raise
        request = Request(
            payload=payload, model=model or self.default_model, deadline=deadline
        )
        if _spans.active_session() is not None:
            # Carry the submitter's trace to the worker thread: batch and
            # request spans re-parent under this context.
            request.trace_ctx = _spans.current_context()
            request.trace_start_s = time.perf_counter()
            _spans.add_span_event("serving.submit", request_id=request.request_id)
        if not self.batcher.offer(request):  # raced to hard-full
            self.telemetry.record_shed(model=request.model)
            raise RequestShed(f"queue hard-full ({self.batcher.capacity})")
        if self._stop.is_set():
            # Raced stop(): the worker may already have passed its final
            # drain check, so nobody would ever serve this request. Settle
            # the future loudly (no-op if the worker did win the race).
            _settle_exception(request.future, ServerClosed())
            raise ServerClosed()
        return request.future

    def submit_many(
        self,
        payloads: Sequence[Any],
        deadline_s: Optional[float] = None,
        model: Optional[str] = None,
    ) -> List[Future]:
        """submit() each payload; sheds come back as completed futures
        carrying :class:`RequestShed` so the result list stays aligned
        with the input order."""
        futures: List[Future] = []
        for payload in payloads:
            try:
                futures.append(self.submit(payload, deadline_s=deadline_s, model=model))
            except (RequestShed, ServerClosed) as exc:
                f: Future = Future()
                _settle_exception(f, exc)
                futures.append(f)
        return futures

    def restamp_compile_baseline(self) -> None:
        """Re-zero ``cufft_plans_since_warmup`` at the CURRENT plan count
        (after out-of-band work at new shapes that is not serving's)."""
        self._plan_baseline = self._cufft_plans()

    # ------------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        out = self.telemetry.snapshot(queue_depth=self.batcher.depth())
        out["admission"] = self.admission.stats()
        out["models"] = self.registry.describe()
        if self._plan_baseline is not None:
            out["cufft_plans_since_warmup"] = self._cufft_plans() - self._plan_baseline
        return out

    # ----------------------------------------------------------------- worker
    def _worker(self) -> None:
        while True:
            wait_s = (self.config.max_wait_ms / 1e3) * self.admission.wait_scale()
            batch = self.batcher.next_batch(
                self.config.max_batch, wait_s, stop=self._stop
            )
            if not batch:
                if self._stop.is_set() and self.batcher.depth() == 0:
                    # Close the submit/stop race: anything offered after
                    # the depth check above fails instead of stranding.
                    self.batcher.fail_all(ServerClosed())
                    return
                continue
            for group in self._group_batch(batch):
                self._apply_group(group[0].model, group)
            self.telemetry.maybe_log(
                self.config.log_interval_s, queue_depth=self.batcher.depth()
            )

    @staticmethod
    def _group_batch(batch: List[Request]) -> List[List[Request]]:
        """Split a batch into stackable groups: same model AND same
        payload structure/shape/dtype. One wrong-shaped request then
        fails (or serves) alone instead of poisoning the whole batch's
        stack."""

        def leaf_signature(leaf):
            # Read shape/dtype off the leaf's own metadata when it has
            # any: copying a device tensor to the host here would sync
            # the device per request just to LOOK at the shape. The
            # asarray fallback only runs for host-native payloads (JSON
            # lists' scalars).
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                host = np.asarray(leaf)  # keystone: allow-sync — host-native leaf, no device copy
                shape, dtype = host.shape, host.dtype
            return (tuple(shape), str(dtype))

        def signature(req: Request):
            try:
                shapes = tuple(leaf_signature(leaf) for leaf in tree_leaves(req.payload))
                return (req.model, tree_structure(req.payload), shapes)
            except Exception:
                return (req.model, "unstackable", id(req))

        groups: Dict[Any, List[Request]] = {}
        for req in batch:
            groups.setdefault(signature(req), []).append(req)
        return list(groups.values())

    def _apply_group(self, model_name: str, group: List[Request]) -> None:
        t_apply = time.monotonic()
        # Worker-side batch span, re-parented under the FIRST member's
        # submit context (one batch serves many traces; every member
        # still gets its request span recorded below).
        with _spans.attach(group[0].trace_ctx), _spans.span(
            "serve:batch", model=model_name, size=len(group)
        ):
            try:
                entry = self.registry.resolve(model_name)
                # The tightest member deadline bounds the retry loop:
                # backing off past it would spend budget no member has
                # left (the retry clock and the request deadline are one
                # clock).
                deadlines = [r.deadline for r in group if r.deadline is not None]
                group_deadline = (
                    min(deadlines, key=lambda d: d.remaining())
                    if deadlines else None
                )
                rows = self._apply_padded(
                    entry, [r.payload for r in group], deadline=group_deadline
                )
            except Exception as exc:
                self.telemetry.record_failure(len(group), model=model_name)
                for req in group:
                    _settle_exception(req.future, exc)
                return
        done = time.monotonic()
        done_perf = time.perf_counter()
        for req in group:
            if req.trace_ctx is not None and req.trace_start_s is not None:
                _spans.record_span(
                    "serve:request",
                    req.trace_start_s,
                    done_perf,
                    parent=req.trace_ctx,
                    request_id=req.request_id,
                    model=model_name,
                    batch_size=len(group),
                    queue_wait_ms=round((t_apply - req.enqueued_at) * 1e3, 3),
                )
        if len(rows) < len(group):
            # A model may legally return fewer logical rows than it was
            # given (e.g. a filtering ObjectDataset transformer) — the
            # unmatched tail must fail loudly, never hang unsettled.
            self.telemetry.record_failure(len(group) - len(rows), model=model_name)
            for req in group[len(rows):]:
                _settle_exception(
                    req.future,
                    ServingError(
                        f"model {model_name!r} returned {len(rows)} rows "
                        f"for a batch of {len(group)}"
                    ),
                )
            group = group[: len(rows)]
        for req, row in zip(group, rows):
            # A deadline that expired DURING apply still gets its result —
            # the work is done; deadlines bound queue/assembly wait.
            _settle_result(req.future, row)
            self.telemetry.record_request(
                latency_s=done - req.enqueued_at,
                queue_wait_s=t_apply - req.enqueued_at,
                model=model_name,
            )
        if self.tap is not None:
            # AFTER every future settled: tap work never delays a
            # response, and a tap bug never fails a served request.
            try:
                self.tap.observe_batch([req.payload for req in group])
            except Exception:
                logger.debug("traffic tap observe failed", exc_info=True)

    def _apply_padded(
        self, entry: ModelEntry, payloads: List[Any], deadline: Any = None
    ) -> List[Any]:
        """Stack payloads on the host, zero-pad to the nearest bucket,
        copy the batch to the device once, apply with retries, copy the
        output to the host once and slice the real rows out there."""
        import torch

        from ..data.dataset import ArrayDataset, _stack

        n = len(payloads)
        bucket = bucket_for(n, self._buckets)
        stacked = tree_map(_stack, *payloads)

        def pad(a):
            extra = bucket - a.shape[0]
            if extra == 0:
                return a
            if isinstance(a, torch.Tensor):
                return torch.cat([a, a.new_zeros((extra,) + tuple(a.shape[1:]))])
            return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1))

        dataset = ArrayDataset(tree_map(pad, stacked), num_examples=n, device=self.device)

        attempts = {"n": 0}

        def attempt():
            attempts["n"] += 1
            probe("serving.apply")
            return entry.batch_apply(dataset)

        policy = self.config.retry_policy
        try:
            if policy is not None:
                out = policy.call(
                    attempt,
                    label=f"serving.apply:{entry.name}",
                    deadline=deadline,
                )
            else:
                out = attempt()
        finally:
            # Count retries whether or not the batch ultimately succeeded:
            # a fault storm that exhausts the policy must still show up.
            for _ in range(attempts["n"] - 1):
                self.telemetry.record_retry(model=entry.name)
        self.telemetry.record_batch(n, bucket, self.config.max_batch, model=entry.name)
        # One device→host copy per output leaf per batch, then rows are
        # sliced on the host: indexing a device tensor per row would sync
        # the device once per request.
        data = getattr(out, "data", None)
        if data is not None and hasattr(out, "num_examples"):
            # The batch's one read-back, by design.  # keystone: allow-sync
            host = tree_map(
                lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
                data,
            )
            return [tree_map(lambda a, i=i: a[i], host) for i in range(n)]
        return out.take(n)


# --------------------------------------------------------------------- CLI


def add_serve_arguments(parser) -> None:
    """Flags for the ``serve`` subcommand (plain argparse)."""
    parser.add_argument("--model", help="FittedPipeline.save artifact to serve")
    parser.add_argument("--checkpoint-dir", help="CheckpointStore directory to serve an entry of")
    parser.add_argument("--digest", help="digest (or unique prefix) of the entry in --checkpoint-dir")
    parser.add_argument(
        "--synthetic", type=int, default=None, metavar="D",
        help="serve a synthetic D-dim dense pipeline (smoke tests, no artifact)",
    )
    parser.add_argument("--model-name", default="default")
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-wait-ms", type=float, default=2.0)
    parser.add_argument("--queue-depth", type=int, default=64)
    parser.add_argument("--deadline-ms", type=float, default=None,
                        help="default per-request deadline")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip bucket warmup before serving")
    parser.add_argument(
        "--device", default=None,
        help="torch device to serve on (default: the CUDA device; 'cpu' to serve on the CPU)",
    )
    parser.add_argument(
        "--workers", type=int, default=1,
        help="worker PROCESSES; >1 runs the supervised multi-worker runtime, "
             "1 keeps the in-process server",
    )
    parser.add_argument(
        "--listen", default=None, metavar="HOST:PORT",
        help="also serve the HTTP JSON front-end (stdin stays a client)",
    )
    parser.add_argument(
        "--slo-p99-ms", type=float, default=None,
        help="enable the SLO controller: drive admission from observed p99 "
             "against this target (multi-worker path)",
    )
    parser.add_argument(
        "--boot-image", default=None, metavar="DIR",
        help="boot workers from a serving boot image (build_boot_image): "
             "weights, kernel libraries and example, no kernel build; a "
             "stale image is refused (KV307) and the worker falls back to "
             "the classic warm path",
    )
    parser.add_argument(
        "--autoscale", action="store_true",
        help="scale worker processes up under sustained p99/backlog pressure "
             "and down on sustained idle",
    )
    parser.add_argument("--min-workers", type=int, default=None, help="autoscale floor (default 1)")
    parser.add_argument(
        "--max-workers", type=int, default=None, help="autoscale ceiling (default max(4, --workers))"
    )


def serve_from_args(args) -> int:
    """Run the stdin/JSON front-end: one request per line
    (``{"id": ..., "x": [...]}`` or a bare array), one response line per
    request as it completes, then a final ``SERVE_STATS:{...}`` line (the
    server's stats and this process's ``device_counts``). The fleet flags
    route to the supervised multi-worker runtime."""
    if args.workers > 1 or args.listen or args.slo_p99_ms or args.boot_image or args.autoscale:
        # Autoscaling and boot images are fleet features, so either flag
        # routes here too.
        from .frontend import serve_multiworker_from_args

        return serve_multiworker_from_args(args)
    from ..device import resolve_device

    device = resolve_device(args.device)
    config = ServingConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        default_deadline_s=(args.deadline_ms / 1e3) if args.deadline_ms else None,
        retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.05),
    )
    registry = ModelRegistry()
    if args.synthetic is not None:
        from .synthetic import synthetic_fitted_pipeline

        registry.publish(
            args.model_name,
            synthetic_fitted_pipeline(d=args.synthetic, device=device),
            source=f"synthetic:d={args.synthetic}",
        )
        example = np.zeros((args.synthetic,), np.float32)
    elif args.model:
        registry.load_fitted(args.model_name, args.model, device=device)
        example = None
    elif args.checkpoint_dir and args.digest:
        registry.load_checkpoint(args.model_name, args.checkpoint_dir, args.digest, device=device)
        example = None
    else:
        print("serve: need --model, --checkpoint-dir + --digest, or --synthetic D", file=sys.stderr)
        return 2

    server = PipelineServer(
        config=config, registry=registry, name=args.model_name, device=device
    )
    server.start()

    out_lock = threading.Lock()

    def emit(obj: Dict[str, Any]) -> None:
        with out_lock:
            print(json.dumps(obj), flush=True)

    def on_done(request_id, t0):
        def callback(future: Future) -> None:
            try:
                row = future.result()
                # Response egress: a host row the server already sliced
                # from the batch's one read-back.  # keystone: allow-sync
                emit({
                    "id": request_id,
                    "y": np.asarray(row).tolist(),
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                })
            except Exception as exc:
                emit({"id": request_id, "error": f"{type(exc).__name__}: {exc}"})

        return callback

    warmed = False
    pending: List[Future] = []
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as exc:
            emit({"error": f"bad request line: {exc}"})
            continue
        try:
            request_id, x, deadline_s, _, model = parse_stdin_request(obj)
        except ValueError as exc:
            emit({"id": obj.get("id"), "error": str(exc)})
            continue
        try:
            # Request ingress: x is a JSON list.  # keystone: allow-sync
            payload = np.asarray(x, np.float32)
            if x is None or payload.ndim == 0:
                raise ValueError(f"x must be an array, got {x!r}")
        except (TypeError, ValueError) as exc:
            # One malformed request must not take the server down for
            # every later request on the stream.
            emit({"id": request_id, "error": f"bad payload: {exc}"})
            continue
        if not warmed and not args.no_warmup:
            server.warmup(example if example is not None else payload)
            warmed = True
        t0 = time.monotonic()
        try:
            future = server.submit(payload, deadline_s=deadline_s, model=model)
        except (RequestShed, RequestTimeout, ServerClosed) as exc:
            emit({"id": request_id, "error": f"{type(exc).__name__}: {exc}"})
            continue
        future.add_done_callback(on_done(request_id, t0))
        pending.append(future)
        if len(pending) >= 4096:
            # Responses were already emitted by on_done; keep only the
            # unsettled tail so a long-lived stream doesn't grow RSS
            # linearly with total requests served.
            pending = [f for f in pending if not f.done()]

    server.stop(drain=True)
    for future in pending:  # callbacks already emitted; just settle
        try:
            future.result(timeout=1.0)
        except Exception:
            pass
    with out_lock:
        print("SERVE_STATS:" + json.dumps({**server.stats(), "device_counts": device_counts(device)}), flush=True)
    return 0
