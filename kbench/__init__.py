"""kbench: the benchmark of keystone_tpu_torch, the PyTorch and CUDA port.

One run is one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) in a fresh process:

    python3 kbench/run.py --workload timit.fit --seed 7 --seconds 10 --trace 0

The harness is driven by data. A cell names a configuration and a
traffic mix; the harness finds everything by those names:

- ``configs/<config>.json``: sizes, source, cuts, precision, limits;
- ``systems/<config>.py``: how the port is driven for that configuration
  (data from the seed, the fit, the scores);
- ``reference/<config>.py``: the plain reference (torch and numpy only);
- ``counts/<config>.py``: the operations one fit needs, from shapes;
- ``traffic/<mix>.json``: the parameters of a traffic mix: its ``kind``
  names its driver, ``drivers/<kind>.py`` (``fit``: whole fits back to
  back; ``serve``: an open loop into the port's server), and an open
  loop's ``arrivals`` name its generator of arrival times,
  ``arrivals/<name>.py``;
- ``metrics/<metric>.py``: one reader per per-layer metric.

Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
