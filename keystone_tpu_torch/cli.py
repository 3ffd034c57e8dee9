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
``REFIT_STATS:`` line).

Usage:
    python -m keystone_tpu_torch <workload> [--flag value ...] [--device cpu]
    python -m keystone_tpu_torch serve (--model PATH | --checkpoint-dir D --digest P | --synthetic D) [--device cpu]
    python -m keystone_tpu_torch fit --store-dir D [--rows N ...] [--device cpu]
    python -m keystone_tpu_torch refit [--rounds N ...] [--device cpu]
    python -m keystone_tpu_torch --list

Every workload of the JAX package is here. Left out for now: its other
subcommands (``profile``, ``trace``, ``bench-diff``, ``check``,
``explain``, ``tune``, ``quality``; ROADMAP item 13b).
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
    serve = sub.add_parser("serve", help="serve a fitted pipeline over stdin/JSON lines")
    fit = sub.add_parser("fit", help="one durable streamed fit (checkpoints, kill-and-resume)")
    refit = sub.add_parser("refit", help="continuous refit over a drifting synthetic workload")
    command = next((a for a in argv if a in ("serve", "fit", "refit")), None) if selected is None else None
    if command == "serve":
        from .serving.server import add_serve_arguments

        add_serve_arguments(serve)
    elif command == "fit":
        from .workflow.fitcmd import add_fit_arguments

        add_fit_arguments(fit)
    elif command == "refit":
        from .refit.daemon import add_refit_arguments

        add_refit_arguments(refit)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    if args.list or not args.workload:
        for name, entry in sorted(WORKLOADS.items()):
            print(f"{name:28s} {entry[-1]}")
        return 0
    if args.workload == "serve":
        from .serving.server import serve_from_args

        return serve_from_args(args)
    if args.workload == "fit":
        from .workflow.fitcmd import fit_from_args

        return fit_from_args(args)
    if args.workload == "refit":
        from .refit.daemon import refit_from_args

        return refit_from_args(args)

    config_cls, run_fn = resolved[args.workload]
    results = run_fn(build_config(config_cls, args), device=args.device)
    print(json.dumps({"workload": args.workload, **printable_results(results)}))
    return 0


def printable_results(results: dict) -> dict:
    """The JSON-serializable scalars of a workload's results dict."""
    return {k: v for k, v in results.items() if isinstance(v, (int, float, str))}


if __name__ == "__main__":
    sys.exit(main())
