"""Run one cell of the benchmark of keystone_tpu_torch on this machine's card.

    python3 kbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last) and each compared number beside its
limit as the last lines of standard error. With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics. Exits non-zero, printing no result, without a CUDA
card (or with fewer cards than the cell asks for), and when the process
holds a module of JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prepare_environment() -> None:
    """Settings made before the port is imported. The port's profile
    store would otherwise grow under ``HOME`` with every run and feed its
    measured-knob pass, so two runs of one cell would not run one plan."""
    os.environ["KEYSTONE_PROFILE_STORE"] = "off"
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="a cell name from BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    _prepare_environment()
    if args.trace:
        # The port's node ranges in the profiler's trace label idle gaps.
        os.environ["KEYSTONE_DEVICE_ANNOTATIONS"] = "1"

    import torch

    from kbench.harness.layout import Layout
    from kbench.harness.runner import execute, report

    layout = Layout()
    cell = layout.cell(args.workload)
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kbench: {args.workload} needs {chips} CUDA card(s); this machine has {found}", file=sys.stderr)
        return 2
    run = execute(layout, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    return report(run)


if __name__ == "__main__":
    sys.exit(main())
