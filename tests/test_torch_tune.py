"""The port's plan-tuning control plane against the JAX package's on the
CPU: the autotuner (``workflow/tune.py``), ``MeasuredKnobRule``
(``workflow/knobs.py``) and ``AutoCacheRule`` (``workflow/autocache.py``).

- ``TuneSpace`` encodings and ``RidgeCostModel`` coefficients equal the
  JAX package's (coefficients rel 1e-9); a ``Tuner`` with an injected
  measure function measures the same candidates in the same order and
  picks the same winner.
- Each task run in both packages over its whole grid persists the same
  store keys.
- On the MNIST random-FFT graph, the same stored measurements make
  ``MeasuredKnobRule`` make the same rewrites, and the same sample
  profiles (an injected clock) make ``AutoCacheRule`` cache the same
  nodes.
"""

import copy

import numpy as np
import pytest

from keystone_tpu.obs import store as jstore
from keystone_tpu.workflow import executor as jexec
from keystone_tpu.workflow import tune as jtune
from keystone_tpu_torch.obs import names as tnames
from keystone_tpu_torch.obs import store as tstore
from keystone_tpu_torch.workflow import executor as texec
from keystone_tpu_torch.workflow import tune as ttune

SMALL_MNIST = dict(num_ffts=2, block_size=256, reg=100.0)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))
    for var in ("KEYSTONE_STREAM_CHUNK_ROWS", "KEYSTONE_SOLVER_BLOCK", "KEYSTONE_SOLVER_PRECISION",
                "KEYSTONE_MEASURED_KNOBS"):
        monkeypatch.delenv(var, raising=False)
    jstore.set_store(None)
    tstore.set_store(None)
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()
    yield
    jstore.set_store(None)
    tstore.set_store(None)
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()


def _surface(cand):
    """A smooth knob surface with its basin at chunk 1024, prefetch 2."""
    return (np.log2(cand["chunk_rows"]) - 10.0) ** 2 + (0.0 if cand["prefetch"] == 2 else 0.7) + 1.0


AXES = {"chunk_rows": [128, 256, 512, 1024, 2048, 4096, 8192], "prefetch": [1, 2], "mode": ["a", "b"]}


def test_space_and_ridge_model_equal_the_jax_packages():
    jspace, tspace = jtune.TuneSpace("s", AXES), ttune.TuneSpace("s", AXES)
    assert tspace.grid() == jspace.grid()
    feats = [tspace.encode(c) for c in tspace.grid()]
    assert feats == [jspace.encode(c) for c in jspace.grid()]
    rng = np.random.default_rng(1)
    pick = rng.choice(len(feats), 9, replace=False)
    cost = rng.uniform(0.5, 5.0, 9)
    jm = jtune.RidgeCostModel().fit([feats[i] for i in pick], cost)
    tm = ttune.RidgeCostModel().fit([feats[i] for i in pick], cost)
    assert np.linalg.norm(tm.coef - jm.coef) <= 1e-9 * np.linalg.norm(jm.coef)
    np.testing.assert_allclose(tm.predict(feats), jm.predict(feats), rtol=1e-9)


@pytest.mark.parametrize("explore,budget", [(0.25, 8), (0.0, 6), (1.0, 10)])
def test_tuner_measures_the_same_candidates_in_the_same_order(explore, budget):
    space = {"chunk_rows": AXES["chunk_rows"], "prefetch": AXES["prefetch"]}
    default = {"chunk_rows": 4096, "prefetch": 1}
    outcomes = []
    for mod in (jtune, ttune):
        tuner = mod.Tuner(budget=budget, explore=explore, seed=3, time_budget_s=1e9)
        outcomes.append(tuner.search(mod.TuneSpace("stream", space), _surface, default=default, maximize=False))
    j, t = outcomes
    assert [(m.knobs, m.proposed_by) for m in t.measured] == [(m.knobs, m.proposed_by) for m in j.measured]
    assert t.winner.knobs == j.winner.knobs and t.improved == j.improved
    assert {k: v for k, v in t.to_json().items() if k != "seconds"} == {
        k: v for k, v in j.to_json().items() if k != "seconds"
    }


def test_tuner_counts_its_candidates():
    before = tnames.metric(tnames.TUNE_CANDIDATES).value(task="stream")
    ttune.Tuner(budget=3, seed=0, time_budget_s=1e9).search(
        ttune.TuneSpace("stream", {"chunk_rows": [256, 512], "prefetch": [1, 2]}), _surface,
    )
    assert tnames.metric(tnames.TUNE_CANDIDATES).value(task="stream") - before == 3


def _keys(store_mod):
    return sorted((k, s) for k, s, m in store_mod.get_store().entries() if m.get("source") == "tune")


@pytest.mark.parametrize("task,kwargs,budget", [
    ("stream", dict(rows=1024, dim=16, classes=2), 4),
    ("solver", dict(rows=512, dim=64, classes=2), 8),
    ("blocksparse", dict(rows=512, dim=256, classes=2), 6),
])
def test_each_task_persists_the_jax_packages_keys(tmp_path, monkeypatch, task, kwargs, budget):
    """Over the whole grid (budget = its size) both packages measure every
    candidate, whatever the walls, so the stores must hold the same keys."""
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "jax.jsonl"))
    jstore.set_store(None)
    jtune.TASKS[task](jtune.Tuner(budget=budget, seed=0, time_budget_s=1e9), jstore.get_store(), **kwargs)
    j_keys = _keys(jstore)
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "port.jsonl"))
    tstore.set_store(None)
    outcome = ttune.TASKS[task](
        ttune.Tuner(budget=budget, seed=0, time_budget_s=1e9), tstore.get_store(), device="cpu", **kwargs
    )
    t_keys = _keys(tstore)
    if task == "stream":
        # The port keys each stream candidate by chunk rows, prefetch depth
        # and shard count (the JAX package by chunk rows alone, where
        # candidates of one chunk size overwrite each other): one entry per
        # candidate, and the JAX keys are their chunk-rows prefixes.
        assert len(t_keys) == budget
        t_keys = sorted({(k.split(":p")[0], s) for k, s in t_keys})
    assert t_keys == j_keys and j_keys
    assert outcome.winner is not None and len(outcome.measured) == budget
    if task == "solver":
        assert outcome.winner.extra["donation_probe"]["status"] == "not_applicable"
    if task == "blocksparse":
        entry = [m for _k, _s, m in tstore.get_store().entries(key_prefix="blocksparse:threshold")][0]
        assert 0.0 <= entry["threshold"] <= 0.35 and entry["source"] == "tune"


def test_tune_cli_writes_winners_the_knob_rule_reads(tmp_path, capsys):
    from keystone_tpu_torch import cli

    rc = cli.main(["tune", "--tasks", "solver", "--rows", "512", "--dim", "32", "--classes", "2",
                   "--budget", "3", "--seed", "0", "--device", "cpu", "--out", str(tmp_path / "t.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "TUNE_JSON:" in out and (tmp_path / "t.json").exists()
    assert tstore.get_store().by_source().get("tune", 0) == 3


# ------------------------------------------------------------ measured knobs


def _mnist(pkg, rows):
    import importlib

    mnist = importlib.import_module(f"{pkg}.pipelines.mnist_random_fft")
    kw = {} if pkg == "keystone_tpu" else {"device": "cpu"}
    train = mnist.synthetic_mnist(rows, seed=0, **kw)
    return mnist.build_pipeline(mnist.MnistRandomFFTConfig(**SMALL_MNIST), train, **kw)


def _record_knob_history(store_mod, rows_bucket_shape):
    store = store_mod.get_store()
    for bs, prec, wall in ((64, "high", 0.5), (128, "high", 0.2), (128, "highest", 0.4)):
        store.record(f"solver:block_ls:bs{bs}:prec{prec}", rows_bucket_shape, wall_s=wall, block_size=bs,
                     precision=prec)


def _plan_knobs(pkg, exec_mod):
    """(label, block size, precision pin, prediction key) of every
    estimator node in the optimized MNIST fit plan. The plan does not
    stream (its featurizer fans in four branches), so the chunk knob has
    nothing to tune; block size and precision do."""
    pipe = _mnist(pkg, 2048)
    graph, _ = exec_mod.PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    out = []
    for node in sorted(graph.nodes):
        op = graph.get_operator(node)
        if hasattr(op, "block_size") and hasattr(op, "num_iter"):
            out.append((type(op).__name__, op.block_size, getattr(op, "solver_precision", None),
                        getattr(getattr(op, "predicted_cost", None), "key", None)))
    return out


@pytest.mark.parametrize("mode", ["on", "all"])
def test_measured_knob_rule_makes_the_jax_packages_rewrites(tmp_path, monkeypatch, mode):
    monkeypatch.setenv("KEYSTONE_MEASURED_KNOBS", mode)
    got = {}
    for name, pkg, store_mod, exec_mod in (("jax", "keystone_tpu", jstore, jexec),
                                           ("port", "keystone_tpu_torch", tstore, texec)):
        monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / f"{name}.jsonl"))
        store_mod.set_store(None)
        _record_knob_history(store_mod, store_mod.shape_class(2048, (8192,), "float32"))
        got[name] = _plan_knobs(pkg, exec_mod)
        exec_mod.PipelineEnv.reset()
    assert got["port"] == got["jax"] and got["port"]
    want = (128, "high") if mode == "all" else (SMALL_MNIST["block_size"], None)
    assert got["port"][0][1:3] == want


def test_measured_knob_rule_pins_the_best_chunk_and_counts_it(monkeypatch):
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.workflow import streaming as tstreaming

    rng = np.random.default_rng(0)
    data = ArrayDataset(rng.standard_normal((8192, 16)).astype(np.float32), device="cpu")
    labels = ArrayDataset(rng.standard_normal((8192, 2)).astype(np.float32), device="cpu")
    shape = tstore.dataset_shape_class(data)
    for cr, rate in ((512, 1e6), (1024, 3e6), (2048, 2e6)):
        tstore.get_store().record(f"stream:{tstreaming.chain_class(())}:cr{cr}", shape, chunk_rows=cr,
                                  rows_per_s=rate, source="tune")
    counter = tnames.metric(tnames.PROFILE_STORE_KNOB_OVERRIDES)
    before = counter.value(knob="stream_chunk_rows")
    pipe = BlockLeastSquaresEstimator(8, reg=1e-2, device="cpu").with_data(data, labels)
    graph, _ = texec.PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    ops = [graph.get_operator(n) for n in graph.nodes]
    stream = [op for op in ops if isinstance(op, tstreaming.StreamingFitOperator)]
    assert len(stream) == 1 and stream[0].chunk_rows == 1024
    assert stream[0].predicted_cost.rows_per_s == 3e6 and stream[0].predicted_cost.calibrated
    assert counter.value(knob="stream_chunk_rows") - before == 1


# --------------------------------------------------------------- auto-cache


def _ticks():
    state = {"t": 0.0}

    def clock():
        state["t"] += 1e-3
        return state["t"]

    return clock


def test_auto_cache_rule_caches_the_jax_packages_nodes(tmp_path, monkeypatch):
    from keystone_tpu.workflow.autocache import AutoCacheRule as JRule
    from keystone_tpu_torch.workflow.autocache import AutoCacheRule as TRule

    got = {}
    for name, pkg, rule_cls, store_mod in (("jax", "keystone_tpu", JRule, jstore),
                                           ("port", "keystone_tpu_torch", TRule, tstore)):
        monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / f"{name}.jsonl"))
        store_mod.set_store(None)
        graph = _mnist(pkg, 512).graph
        rule = rule_cls(budget_bytes=1 << 40, clock=_ticks(), profile_scales=(16, 32))
        dependents = rule._dependents(graph)
        candidates = rule._candidates(graph, dependents)
        profiles = rule._profile(graph)
        new_graph, _ = rule_cls(budget_bytes=1 << 40, clock=_ticks(), profile_scales=(16, 32)).apply(
            copy.deepcopy(graph), {}
        )
        cached = sorted(
            str(getattr(new_graph.get_operator(d), "label", "")) for n in new_graph.nodes
            if type(new_graph.get_operator(n)).__name__ == "CacherOperator"
            for d in new_graph.get_dependencies(n)
        )
        got[name] = (sorted(map(str, candidates)), {str(k): round(p.run_time_s, 9) for k, p in profiles.items()},
                     cached)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2] == got["jax"][2] and got["port"][2]


def test_auto_cache_warm_starts_from_the_store(monkeypatch):
    from keystone_tpu_torch.workflow.autocache import AutoCacheRule

    graph = _mnist("keystone_tpu_torch", 512).graph
    first = AutoCacheRule(clock=_ticks(), profile_scales=(16, 32))._profile(graph)
    samples = tnames.metric(tnames.AUTOCACHE_PROFILE_SECONDS)
    before = sum(s.count for s in samples.series().values())
    again = AutoCacheRule(clock=_ticks(), profile_scales=(16, 32))._profile(graph)
    assert {k: (p.run_time_s, p.size_bytes) for k, p in again.items()} == {
        k: (p.run_time_s, p.size_bytes) for k, p in first.items()
    }
    assert sum(s.count for s in samples.series().values()) == before  # no sample run


def test_auto_caching_optimizer_counts_its_cacher_nodes():
    from keystone_tpu_torch.workflow.autocache import AutoCacheRule
    from keystone_tpu_torch.workflow.rules import auto_caching_optimizer

    stack = auto_caching_optimizer(budget_bytes=1 << 40)
    for batch in stack.batches:  # the injected clock: a decision independent of the host's load
        batch.rules = [AutoCacheRule(budget_bytes=1 << 40, clock=_ticks(), profile_scales=(16, 32))
                       if isinstance(r, AutoCacheRule) else r for r in batch.rules]
    texec.PipelineEnv.get_or_create().optimizer = stack
    misses = tnames.metric(tnames.AUTOCACHE_MISSES)
    cached = tnames.metric(tnames.AUTOCACHE_CACHED_NODES)
    m0, c0 = misses.value(), cached.value()
    _mnist("keystone_tpu_torch", 512).fit()
    # Each inserted Cacher node executes once (a miss) in the fit.
    assert cached.value() > c0 and misses.value() - m0 == cached.value() - c0
