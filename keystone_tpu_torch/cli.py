"""Command-line workload runner.

Port of ``keystone_tpu/cli.py``'s workload runner: one argparse
subcommand per workload, generated from the workload's config dataclass
(field names become ``--flags``, field types parsers, defaults defaults),
plus ``--device`` (default: the CUDA device; ``--device cpu`` runs on the
CPU). It prints one JSON line ``{"workload": ..., <scalar results>}``.
The ``serve`` subcommand answers JSON request lines on stdin with a fitted
pipeline (``serving/server.py``); ``fit`` runs one durable streamed fit
(``workflow/fitcmd.py``, a ``FIT_STATS:`` line); ``refit`` runs the
drifting-workload continuous-refit loop (``refit/daemon.py``, a
``REFIT_STATS:`` line). The observability and control-plane commands:
``profile`` (``obs/profile.py``: an instrumented fit → apply → serve run,
a Chrome trace and a Prometheus file), ``trace`` (``obs/fleet.py``: a
multiworker sweep, the merged fleet trace), ``bench-diff``
(``obs/benchdiff.py``), ``explain`` (``workflow/explain.py``: per-node
predicted vs measured cost against the card's roofline; ``--schedule``
the co-scheduler demo), ``tune`` (``workflow/tune.py``: the offline
autotuner) and ``quality`` (``obs/quality_cli.py``). ``check``
(``lint/check.py``) is the static tier: keystone-lint (``--lint``), the
concurrency analysis (``--concurrency``) — both without importing torch —
and plan-time verification of a saved pipeline (``--pipeline``). Flag
wiring imports no torch: ``--help`` of every subcommand runs without it.

Usage:
    python -m keystone_tpu_torch <workload> [--flag value ...] [--device cpu]
    python -m keystone_tpu_torch serve (--model PATH | --checkpoint-dir D --digest P | --synthetic D) [--device cpu]
    python -m keystone_tpu_torch fit --store-dir D [--rows N ...] [--device cpu]
    python -m keystone_tpu_torch refit [--rounds N ...] [--device cpu]
    python -m keystone_tpu_torch {profile,explain,tune} [...] [--device cpu]
    python -m keystone_tpu_torch trace [--backend synthetic --device cpu]
    python -m keystone_tpu_torch {bench-diff,quality} [...]
    python -m keystone_tpu_torch check [--lint] [--concurrency] [--pipeline PATH|synthetic ...] [--json]
    python -m keystone_tpu_torch --list

Every workload and subcommand of the JAX package is here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import typing
from typing import Any, Callable, Dict, Optional, Tuple


def _parse_bool(text: str) -> Optional[bool]:
    """``true``/``false`` (or ``1``/``0``, ``yes``/``no``); ``none`` for
    ``None``."""
    value = text.strip().lower()
    if value in ("none", ""):
        return None
    if value in ("true", "1", "yes"):
        return True
    if value in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true, false or none; got {text!r}")


def _field_parser(field_type: Any) -> Optional[Callable[[str], Any]]:
    """Map a dataclass field annotation (``int``, ``float``, ``str``,
    ``bool``, a tuple of one of them, or ``Optional`` of one) to an
    argparse type callable. A tuple reads as ``256x256`` or ``256,256``; a
    bool as ``true``/``false`` (``none`` for an ``Optional`` one)."""
    origin = typing.get_origin(field_type)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(field_type) if a is not type(None)]
        return _field_parser(args[0]) if len(args) == 1 else str
    if origin is tuple:
        inner = typing.get_args(field_type)
        caster = inner[0] if inner else int

        def parse_tuple(text: str):
            return tuple(caster(p) for p in text.replace("x", ",").split(",") if p)

        return parse_tuple
    if field_type is bool:
        return _parse_bool
    if field_type in (int, float, str):
        return field_type
    return None


def add_config_arguments(parser: argparse.ArgumentParser, config_cls) -> None:
    """Generate ``--flag`` options from a config dataclass."""
    hints = typing.get_type_hints(config_cls)
    for field in dataclasses.fields(config_cls):
        caster = _field_parser(hints[field.name])
        if caster is None:
            continue
        parser.add_argument(
            "--" + field.name.replace("_", "-"),
            dest=field.name,
            type=caster,
            default=field.default,
            help=f"(default: {field.default!r})",
        )


def build_config(config_cls, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(config_cls)}
    return config_cls(**{k: v for k, v in vars(args).items() if k in names})


def _add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA device; 'cpu' to run on the CPU)",
    )


def add_explain_arguments(parser: argparse.ArgumentParser) -> None:
    """Flags for ``explain`` — wired here so --help/--list never import the
    workflow package (which imports torch); ``workflow.explain`` consumes
    the parsed namespace at dispatch time."""
    parser.add_argument(
        "--pipeline", default="synthetic", metavar="PATH|synthetic|hashing-tf|mnist",
        help="FittedPipeline.save artifact to explain, 'synthetic' (featurize "
        "chain + block solve under the auto-cache optimizer), 'hashing-tf' "
        "(hashed text → block-sparse fit through the ELL kernel) or 'mnist' "
        "(the MNIST random-FFT pipeline)",
    )
    parser.add_argument("--rows", type=int, default=2048, help="training rows (documents for hashing-tf)")
    parser.add_argument(
        "--dim", type=int, default=64,
        help="feature width: the synthetic pipeline's, the hashing-tf feature "
        "count, or — for --pipeline PATH — the artifact's input width",
    )
    parser.add_argument("--classes", type=int, default=4, help="label width")
    parser.add_argument("--num-ffts", type=int, default=4, help="FFT branches of --pipeline mnist")
    parser.add_argument(
        "--passes", type=int, default=3,
        help="plan executions: a pass that built a kernel is cold (never "
        "drift-scored), later passes measure steady state",
    )
    parser.add_argument(
        "--seed-drift", type=float, default=0.0, metavar="FACTOR",
        help="corrupt stored autocache measurements by FACTOR× (the negative "
        "control: the drift sentinel must flag it)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="write report JSON here")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="print EXPLAIN_JSON: line instead of the human table",
    )
    parser.add_argument(
        "--schedule", action="store_true",
        help="run the co-scheduled serving+refit demo and print the card's "
        "schedule instead: per lease — who ran, what displaced or deferred "
        "it, predicted vs measured wall, price provenance",
    )
    _add_device_argument(parser)


def add_tune_arguments(parser: argparse.ArgumentParser) -> None:
    """Flags for ``tune`` — wired here so --help/--list never import the
    workflow package; ``workflow.tune.tune_from_args`` consumes them."""
    parser.add_argument(
        "--tasks", default="stream,solver,blocksparse",
        help="comma-separated tune tasks (stream, solver, blocksparse)",
    )
    parser.add_argument("--rows", type=int, default=8192, help="synthetic problem rows")
    parser.add_argument("--dim", type=int, default=256, help="synthetic feature width")
    parser.add_argument("--classes", type=int, default=4, help="synthetic label width")
    parser.add_argument(
        "--budget", type=int, default=None,
        help="max measured candidates per task (default KEYSTONE_TUNE_BUDGET)",
    )
    parser.add_argument("--seed", type=int, default=None, help="exploration seed (default KEYSTONE_TUNE_SEED)")
    parser.add_argument(
        "--time-budget-s", type=float, default=None,
        help="per-task wall budget (default KEYSTONE_TUNE_TIME_S)",
    )
    parser.add_argument("--out", default=None, help="write result JSON here")
    _add_device_argument(parser)


#: Subcommands beside the workloads: name → (help, flag-wiring module,
#: flag-wiring function or None for this module's, dispatch module,
#: dispatch function). Flag wiring imports no torch.
COMMANDS: Dict[str, Tuple[str, Optional[str], str, str, str]] = {
    "serve": ("serve a fitted pipeline over stdin/JSON lines",
              ".serving.server", "add_serve_arguments", ".serving.server", "serve_from_args"),
    "fit": ("one durable streamed fit (checkpoints, kill-and-resume)",
            ".workflow.fitcmd", "add_fit_arguments", ".workflow.fitcmd", "fit_from_args"),
    "refit": ("continuous refit over a drifting synthetic workload",
              ".refit.daemon", "add_refit_arguments", ".refit.daemon", "refit_from_args"),
    "profile": ("instrumented fit → apply → serve: Chrome trace + Prometheus snapshot",
                ".obs.profile", "add_profile_arguments", ".obs.profile", "profile_from_args"),
    "trace": ("fleet trace: multiworker sweep → merged Perfetto trace + /metrics scrape",
              ".obs.fleet", "add_trace_arguments", ".obs.fleet", "trace_from_args"),
    "bench-diff": ("compare two benchmark json artifacts, fail on regression",
                   ".obs.benchdiff", "add_bench_diff_arguments", ".obs.benchdiff", "bench_diff_from_args"),
    "explain": ("cost observatory: predicted vs measured per node, roofline placement, drift",
                None, "add_explain_arguments", ".workflow.explain", "explain_from_args"),
    "tune": ("offline autotuner: measured knob search → profile-store winners",
             None, "add_tune_arguments", ".workflow.tune", "tune_from_args"),
    "quality": ("quality-plane report: score streams, drift state, sequential decisions",
                ".obs.quality_cli", "add_quality_arguments", ".obs.quality_cli", "quality_from_args"),
    "check": ("static tier: keystone-lint, concurrency analysis, plan-time pipeline verification",
              ".lint.check", "add_check_arguments", ".lint.check", "check_from_args"),
}


# name → (module, config class name, run callable name, bound keyword
# arguments, description). Static strings only: --list and help import no
# pipeline.
WORKLOADS: Dict[str, Tuple[str, str, str, Dict[str, Any], str]] = {
    "mnist-random-fft": (
        "mnist_random_fft", "MnistRandomFFTConfig", "run", {},
        "MNIST random-FFT featurization + linear solve",
    ),
    "timit": (
        "timit", "TimitConfig", "run", {},
        "TIMIT cosine random features + block least squares",
    ),
    "amazon-reviews": (
        "text", "AmazonReviewsConfig", "run_amazon", {},
        "Amazon reviews n-gram logistic/LBFGS text pipeline",
    ),
    "newsgroups": (
        "text", "NewsgroupsConfig", "run_newsgroups", {},
        "20 Newsgroups n-gram naive-bayes/least-squares pipeline",
    ),
    "voc-sift-fisher": (
        "voc", "SIFTFisherConfig", "run", {},
        "VOC 2007 SIFT + Fisher Vector + block least squares",
    ),
    "imagenet-sift-lcs-fv": (
        "imagenet", "ImageNetSiftLcsFVConfig", "run", {},
        "ImageNet dual-branch SIFT+LCS Fisher Vector pipeline",
    ),
    "imagenet-native": (
        "imagenet", "ImageNetSiftLcsFVConfig", "run_native_resolution", {},
        "ImageNet SIFT+LCS+FV with per-image native-resolution featurization",
    ),
    "imagenet-native-streaming": (
        "imagenet_streaming", "ImageNetSiftLcsFVConfig",
        "run_native_resolution_streaming", {},
        "Native-resolution flagship via the fused streaming path (at-scale)",
    ),
    "stupid-backoff": (
        "stupid_backoff", "StupidBackoffConfig", "run", {},
        "Stupid Backoff n-gram language model",
    ),
    **{
        "cifar-" + v.replace("_", "-"): (
            "cifar", "RandomCifarConfig", "run", {"variant": v},
            f"CIFAR-10 {v} workload",
        )
        for v in (
            "linear_pixels", "random", "random_patch", "random_patch_fused",
            "random_patch_kernel", "random_patch_augmented",
            "random_patch_kernel_augmented",
        )
    },
}


def _resolve(name: str) -> Tuple[Any, Callable[..., dict]]:
    """Import one workload's module and bind (config_cls, run_fn)."""
    import functools
    import importlib

    module_name, config_name, run_name, kwargs, _desc = WORKLOADS[name]
    module = importlib.import_module(f".pipelines.{module_name}", package="keystone_tpu_torch")
    return getattr(module, config_name), functools.partial(getattr(module, run_name), **kwargs)


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="keystone_tpu_torch",
        description="PyTorch/CUDA port of keystone_tpu — workload runner",
    )
    parser.add_argument("--list", action="store_true", help="list workloads")
    sub = parser.add_subparsers(dest="workload")

    selected = next((a for a in argv if a in WORKLOADS), None)
    resolved: Dict[str, Tuple[Any, Callable[..., dict]]] = {}
    for name, entry in WORKLOADS.items():
        sp = sub.add_parser(name, help=entry[-1])
        sp.add_argument(
            "--device", default=None,
            help="torch device to run on (default: the CUDA device; 'cpu' to run on the CPU)",
        )
        if name == selected:
            resolved[name] = _resolve(name)
            add_config_arguments(sp, resolved[name][0])
    import importlib

    command = next((a for a in argv if a in COMMANDS), None) if selected is None else None
    for name, (help_text, wiring_module, wiring_fn, _mod, _fn) in COMMANDS.items():
        sp = sub.add_parser(name, help=help_text)
        if name == command:
            module = (
                importlib.import_module(wiring_module, package="keystone_tpu_torch")
                if wiring_module else sys.modules[__name__]
            )
            getattr(module, wiring_fn)(sp)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    if args.list or not args.workload:
        for name, entry in sorted(WORKLOADS.items()):
            print(f"{name:28s} {entry[-1]}")
        for name, entry in COMMANDS.items():
            print(f"{name:28s} {entry[0]}")
        return 0
    # A multi-host launch sets KEYSTONE_DISTRIBUTED=1: join the process
    # group (KEYSTONE_COORDINATOR / KEYSTONE_NUM_HOSTS / KEYSTONE_HOST_ID,
    # or a launcher's MASTER_ADDR / WORLD_SIZE / RANK) before any device
    # use.
    from .envknobs import env_set

    if env_set("KEYSTONE_DISTRIBUTED"):
        from .parallel.mesh import distributed_init

        distributed_init()
    if args.workload in COMMANDS:
        _help, _wm, _wf, module_name, fn_name = COMMANDS[args.workload]
        module = importlib.import_module(module_name, package="keystone_tpu_torch")
        return getattr(module, fn_name)(args)

    config_cls, run_fn = resolved[args.workload]
    results = run_fn(build_config(config_cls, args), device=args.device)
    print(json.dumps({"workload": args.workload, **printable_results(results)}))
    return 0


def printable_results(results: dict) -> dict:
    """The JSON-serializable scalars of a workload's results dict."""
    return {k: v for k, v in results.items() if isinstance(v, (int, float, str))}


if __name__ == "__main__":
    sys.exit(main())
