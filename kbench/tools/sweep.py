"""Find the highest request rate the port's server sustains for a serve
cell: one server, fitted and warmed once, offered a rising series of
Poisson rates for a few seconds each; per rate the completed rate, the
latency quantiles (from each request's due time) and whether latency
grew through the offer (a growing backlog).

    python3 kbench/tools/sweep.py --config cifar_random_patch --traffic serve_poisson \
        --rates 250,500,1000 --seconds 4 --seed 5

A configuration and a serve mix are named rather than a cell, since the
sweep comes before the cell. The knee is the highest rate that completes
at the offered rate with no growing backlog; a cell offers four fifths of
it (``rate_per_s`` in its traffic file, written there as a number).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="a configuration name (configs/<name>.json)")
    parser.add_argument("--traffic", required=True, help="a serve mix (traffic/<name>.json)")
    parser.add_argument("--rates", required=True, help="comma-separated requests per second")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seed", type=int, default=5)
    args = parser.parse_args(argv)
    os.environ["KEYSTONE_PROFILE_STORE"] = "off"
    sys.path.insert(0, ROOT)

    import statistics

    import torch

    from kbench.harness.layout import Cell, Layout
    from kbench.harness.runner import Run

    layout = Layout()
    serve = layout.module("drivers", "serve")
    _percentile, schedule, start_server = serve._percentile, serve.schedule, serve.start_server
    config = layout.load_json(layout.bench_dir / "configs" / f"{args.config}.json")
    cell = Cell(name=f"{args.config}.{args.traffic}", entry={}, config=config, traffic=layout.traffic(args.traffic),
                end_to_end=[], per_layer=[])
    run = Run(layout=layout, cell=cell, seed=args.seed, seconds=args.seconds, traced=False,
              device=torch.device("cuda", 0))
    system = layout.module("systems", cell.config["name"])
    data = system.make_serve_data(cell.config, cell.traffic, args.seed, run.device)
    server, payloads = start_server(run, system, cell.config, cell.traffic, data)
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            load = schedule(layout, cell.traffic, server, payloads, rate, args.seconds, args.seed + 10 + i)
            load.run()
            load.settle(60.0 + args.seconds)
            lat = load.latencies_ms()
            done = [d for d in load.done if d != float("inf")]
            span = (max(done) - load.due[0]) if done else float("inf")
            half = len(lat) // 2
            print(json.dumps({
                "rate": rate, "offered": len(lat), "failed": sum(1 for v in lat if v == float("inf")),
                "completed_per_s": len(done) / span if span > 0 else 0.0,
                "p50_ms": _percentile(lat, 50), "p95_ms": _percentile(lat, 95), "p99_ms": _percentile(lat, 99),
                "p95_first_half_ms": _percentile(lat[:half], 95), "p95_second_half_ms": _percentile(lat[half:], 95),
                "lateness_p99_ms": _percentile([v * 1e3 for v in load.lateness], 99),
                "median_lateness_ms": statistics.median(v * 1e3 for v in load.lateness),
            }), flush=True)
    finally:
        server.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
