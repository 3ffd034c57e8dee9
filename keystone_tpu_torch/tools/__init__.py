"""Command-line tools of the port that are not workloads, each run with
``python -m keystone_tpu_torch.tools.<name>``:

- :mod:`.solver_comparison` — times the least-squares rungs over a shape
  grid on a device and fits the cost model's ``CostWeights`` to the
  measurements (``--fit-constants``).
"""
