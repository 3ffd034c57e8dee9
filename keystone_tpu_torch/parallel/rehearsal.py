"""Multi-process rehearsal: one process per host, a real cross-process
collective under the sharded Gram.

The port of the JAX package's ``scripts/multihost_rehearsal.py``. Each
process:

1. calls :func:`~keystone_tpu_torch.parallel.mesh.distributed_init` with
   the coordinator, process count and its own id;
2. builds a hybrid mesh whose ``replica`` axis is the process group and
   whose ``data`` axis is ``--local-shards`` shards of its device;
3. assembles its own rows of a known matrix (``n = 8 · shards`` rows over
   all shards, ``d = 16``, ``arange % 23 / 23``), never the whole matrix;
4. runs the sharded ``linalg.gram`` — per-shard partial products, the
   local shards summed in shard order, then the processes' partials
   all-gathered and added in rank order;
5. checks the Gram against the closed form in float64 and prints
   ``REHEARSAL_OK rel_err=… mode=<backend>``.

Two processes on the CPU::

    python -m keystone_tpu_torch.parallel.rehearsal --coordinator 127.0.0.1:29500 \\
        --num-hosts 2 --host-id 0 --local-shards 4 --device cpu &
    python -m keystone_tpu_torch.parallel.rehearsal --coordinator 127.0.0.1:29500 \\
        --num-hosts 2 --host-id 1 --local-shards 4 --device cpu

On a machine with one card, ``--device cuda`` puts both processes' shards
on it and the exchange runs on ``gloo`` (``--backend``, the default on a
card shared by both ranks is refused by NCCL: "Duplicate GPU detected").
With one card per rank, ``--backend nccl``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m keystone_tpu_torch.parallel.rehearsal")
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-hosts", type=int, required=True)
    ap.add_argument("--host-id", type=int, required=True)
    ap.add_argument("--local-shards", type=int, default=4, help="data shards each process holds")
    ap.add_argument("--device", default="cuda", help="cpu or cuda (default cuda)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: gloo when ranks share a card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..device import resolve_device
    from . import linalg
    from .collectives import calls
    from .mesh import distributed_init, make_hybrid_mesh, row_axes

    device = resolve_device(args.device)
    backend = args.backend
    if backend is None:
        shared = device.type == "cpu" or torch.cuda.device_count() < args.num_hosts
        backend = "gloo" if shared else "nccl"
    distributed_init(args.coordinator, args.num_hosts, args.host_id, backend=backend)
    import torch.distributed as dist

    try:
        if device.type == "cuda" and dist.get_backend() == "nccl":
            device = torch.device("cuda", args.host_id % torch.cuda.device_count())
        mesh = make_hybrid_mesh(num_replicas=args.num_hosts, devices=[device] * args.local_shards)
        world = dist.get_world_size()
        shards = args.local_shards * world
        print(
            f"host {dist.get_rank()}/{world}: {args.local_shards} local / {shards} global shards "
            f"{mesh} axes={row_axes(mesh)}",
            flush=True,
        )
        n, d = 8 * shards, 16
        full = np.arange(n * d, dtype=np.float32).reshape(n, d) % 23 / 23.0
        rows = n // world
        mine = full[dist.get_rank() * rows : (dist.get_rank() + 1) * rows]
        x = torch.from_numpy(np.ascontiguousarray(mine)).to(device)
        ata, _ = linalg.gram(x, mesh=mesh)
        got = ata.double().cpu().numpy()
        want = full.T.astype(np.float64) @ full.astype(np.float64)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        if not rel <= 1e-5:
            print(f"REHEARSAL_FAILED rel_err={rel:.3e}", flush=True)
            return 1
        print(
            f"REHEARSAL_OK rel_err={rel:.2e} mode={dist.get_backend()} "
            f"process_all_gather={calls['process_all_gather']}",
            flush=True,
        )
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
