"""The control's readings of the comparison that decides ``correct``, per
seed, at a cell's own sizes: the plain reference computed at a lower
precision, in the program's place, against the float64 reference, on
the inputs a run of that seed makes.

    python3 kbench/tools/control.py --workload timit.fit --seeds 1,2,3 --control tf32

One JSON line per seed. The program's readings are the ``check`` lines
of ``run.py`` runs, the timed path's own. The limits in a configuration's
file lie between the largest program reading over a dozen seeds or more
and the smallest control reading (PERF.md lists both).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control", default="tf32", help="a reference precision below float64")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    os.environ["KEYSTONE_PROFILE_STORE"] = "off"
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from kbench.harness.checks import score_gap
    from kbench.harness.layout import Layout

    layout = Layout()
    cell = layout.cell(args.workload)
    config, traffic = cell.config, cell.traffic
    system, reference = layout.module("systems", config["name"]), layout.module("reference", config["name"])
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if traffic["kind"] == "serve":
            data = system.make_serve_data(config, traffic, seed, device)
            pool = data["pool"]
            pick = np.random.default_rng(seed + 2).choice(len(pool), size=min(int(traffic["check_requests"]), len(pool)),
                                                          replace=False)
            eval_sets = {"served": torch.from_numpy(pool[np.sort(pick)]).to(device)}
        else:
            data = system.make_data(config, seed, device)
            eval_sets = system.eval_sets(config, data, seed)
        want = reference.fit_and_score(config, system.fit_inputs(data), eval_sets, seed, "fp64", device)
        ctrl = reference.fit_and_score(config, system.fit_inputs(data), eval_sets, seed, args.control, device)
        line = {"seed": seed, "side": f"control_{args.control}",
                **{f"{k}_score_gap": score_gap(ctrl[k], want[k]) for k in ctrl}}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del data, eval_sets, want, ctrl
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
