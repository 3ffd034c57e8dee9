"""Port parity for the reliability and observability wiring of the fits:
the block solver's OOM degradation ladder, the executor's retry and fault
injection, ``trace()``'s spans and node-seconds histogram, the rule
counters, the profile store and the dispatch threshold it tunes, and the
CSV loader's quarantine publishing — ``keystone_tpu_torch`` on the CPU
against ``keystone_tpu`` on the same seeded numpy inputs (the JAX side on
its ``impl="lax"`` path).

Bounds: ladder records, recovery summaries, rung-attempt counts, span
names, histogram counts, rule counters, store keys and dispatch
thresholds are exact. Weights of the same degraded fit ≤ ``WEIGHT_TOL``
= 1e-5 relative Frobenius (measured 4.8e-7 in core, 4.9e-7 host-streamed,
7.7e-7 block-sparse: XLA and PyTorch's BLAS/LAPACK round the Gram and
Cholesky in another order); the retried MNIST fit's scores against the
clean fit's in the same package are bitwise equal, and against the JAX
package's ≤ ``SOLVE_TOL`` = 1e-4 (measured 2.9e-6), the bound of
``tests/test_torch_mnist.py``.
"""

import json
import os
import subprocess
import sys
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

import keystone_tpu.obs.names as jnames
import keystone_tpu.obs.store as jstore
import keystone_tpu.ops.pallas.blocksparse as jbs
import keystone_tpu.reliability as jrel
import keystone_tpu.workflow.executor as jexec
import keystone_tpu.workflow.tracing as jtracing
import keystone_tpu_torch.obs.names as tnames
import keystone_tpu_torch.obs.store as tstore
import keystone_tpu_torch.ops.cuda.blocksparse as tbs
import keystone_tpu_torch.reliability as trel
import keystone_tpu_torch.workflow.executor as texec
import keystone_tpu_torch.workflow.tracing as ttracing
from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
from keystone_tpu.data.loaders.csv import load_csv as j_load_csv
from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JEstimator
from keystone_tpu.pipelines import mnist_random_fft as jm
from keystone_tpu.utils.sparse import block_density as j_block_density
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.data.loaders.csv import load_csv
from keystone_tpu_torch.obs import solver as solver_obs
from keystone_tpu_torch.obs import spans as tspans
from keystone_tpu_torch.ops.cuda import _build, gemm
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.parallel import linalg as tlinalg
from keystone_tpu_torch.pipelines import mnist_random_fft as tm
from keystone_tpu_torch.utils.sparse import block_density

CPU = torch.device("cpu")
WEIGHT_TOL, SOLVE_TOL = 1e-5, 1e-4
BM, BN = 8, 16
SMALL_MNIST = dict(num_ffts=2, block_size=512, reg=10.0)
FUSED = "Fused[RandomSignNode+PaddedFFT+LinearRectifier]"
SOLVE_SITE = "BlockLeastSquaresEstimator.solve"
#: Spans of the JAX optimizer that the port does not open (none since
#: the partition batch was ported).
UNPORTED_SPANS: set = set()
#: Spans only the port opens: the planner's and the block solver's steps.
PORT_SPANS = {"plan", "plan:verify", "bcd:block", "bcd:rhs", "bcd:gram", "bcd:factor", "bcd:solve", "bcd:update"}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Fresh pipeline state in both packages and a store file of this
    test's own (both packages read ``KEYSTONE_PROFILE_STORE``)."""
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "profile-store.jsonl"))
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()
    yield
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _block_sparse_dense(rng, m, d, density):
    """Dense (m, d) matrix whose nonzero structure is block-sparse."""
    nbr, nbc = -(-m // BM), -(-d // BN)
    keep = rng.rand(nbr, nbc) < density
    keep[0, 0] = True
    vals = rng.randn(nbr, BM, nbc, BN).astype(np.float32)
    return (vals * keep[:, None, :, None]).reshape(nbr * BM, nbc * BN)[:m, :d]


def _problem(path):
    """(x, y, estimator kwargs) for one of the three fit paths."""
    rng = np.random.RandomState(3)
    if path == "sparse":  # Gram condition ≈ 90: weights comparable in fp32
        x = _block_sparse_dense(rng, 512, 256, 0.2)
        return x, rng.randn(512, 2).astype(np.float32), {}
    x = rng.randn(160, 128).astype(np.float32)
    y = (x @ rng.randn(128, 3)).astype(np.float32) + 0.1 * rng.randn(160, 3).astype(np.float32)
    return x, y, {"host_streaming": path == "host_streamed"}


def _rung_attempts(names):
    counter = names.metric(names.SOLVER_RUNG_ATTEMPTS)
    return {s: counter.value(solver=s) for s in ("block_ls", "block_ls_sparse")}


def _fit_both(path, spec, monkeypatch):
    """The same fit in both packages under the same fault spec:
    ``(outcome, summary, rung attempts)`` per package, where the outcome
    is the model or the exception raised."""
    if path == "sparse":
        monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", f"{BM}x{BN}")
        monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.3")
    x, y, kw = _problem(path)
    out = {}
    for name, rel, names, make in (
        ("jax", jrel, jnames, lambda: JEstimator(64, num_iter=2, reg=1e-3, **kw).fit(
            JArrayDataset(x), JArrayDataset(y))),
        ("port", trel, tnames, lambda: BlockLeastSquaresEstimator(
            64, num_iter=2, reg=1e-3, device=CPU, **kw).fit(
            ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))),
    ):
        before = _rung_attempts(names)
        with rel.injected(rel.FaultSpec(**spec)):
            try:
                outcome = make()
            except Exception as exc:  # the exhausted ladder's error is compared below
                outcome = exc
        after = _rung_attempts(names)
        out[name] = (outcome, rel.get_recovery_log().summary(),
                     {s: after[s] - before[s] for s in after})
    return out


@pytest.mark.parametrize("path", ["in_core", "host_streamed", "sparse"])
def test_ladder_halves_the_block_on_an_injected_oom(path, monkeypatch):
    out = _fit_both(path, dict(match=SOLVE_SITE, kind="oom", first_n=1), monkeypatch)
    (jmodel, jsum, jattempts), (tmodel, tsum, tattempts) = out["jax"], out["port"]
    assert tmodel.degradation == jmodel.degradation
    assert tmodel.degradation["rung"] == 32 and tmodel.degradation["first_rung"] == 64
    assert tmodel.block_size == 32
    assert tsum == jsum and tsum["degradations"] == 1
    solver = "block_ls_sparse" if path == "sparse" else "block_ls"
    assert tattempts == jattempts and tattempts[solver] == 2
    assert _rel(tmodel.weights.numpy(), np.asarray(jmodel.weights)) <= WEIGHT_TOL


@pytest.mark.parametrize("path", ["in_core", "host_streamed", "sparse"])
def test_ladder_exhausted_when_every_rung_runs_out_of_memory(path, monkeypatch):
    out = _fit_both(path, dict(match=SOLVE_SITE, kind="oom", first_n=99), monkeypatch)
    (jexc, jsum, jattempts), (texc, tsum, tattempts) = out["jax"], out["port"]
    assert isinstance(jexc, jrel.LadderExhausted) and isinstance(texc, trel.LadderExhausted)
    assert str(texc) == str(jexc)
    assert tsum == jsum and tsum["degradations"] == 0
    solver = "block_ls_sparse" if path == "sparse" else "block_ls"
    assert tattempts == jattempts and tattempts[solver] == 3  # 64, 32, 16


def test_a_failed_rung_holds_no_memory_into_the_next(monkeypatch):
    """The ladder keeps the error's text only, and neither the rung span
    nor the fit span keeps the exception: the failed attempt's tensors
    are gone (no garbage collection needed) when the next rung starts,
    with a span session recording everything."""
    real = tlinalg.block_coordinate_descent_streaming
    held = []

    def streaming(x_host, y, *args, **kwargs):
        if not held:
            panel = torch.empty(1024, 64)  # stands in for the rung's device buffers
            held.append(weakref.ref(panel))
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        held.append(held[0]() is None)
        return real(x_host, y, *args, **kwargs)

    streaming.blocks_uploaded = streaming.bytes_uploaded = 0  # the real one counts on its name
    monkeypatch.setattr(tlinalg, "block_coordinate_descent_streaming", streaming)
    x, y, kw = _problem("host_streamed")
    with tspans.tracing_session("t") as session:
        model = BlockLeastSquaresEstimator(64, reg=1e-3, device=CPU, **kw).fit(
            ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    assert held[1] is True
    assert model.degradation["rung"] == 32
    assert model.degradation["reduction_reason"].startswith("OutOfMemoryError: CUDA out of memory")
    rungs = session.find("solver:iteration")
    assert [s.status for s in rungs] == ["error", "ok"]
    assert [s.name for s in session.find("solver:fit")] == ["solver:fit"]


def test_a_non_oom_kernel_failure_is_reraised_not_degraded(monkeypatch):
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", f"{BM}x{BN}")
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.3")

    def failing(*args, **kwargs):
        _build.raise_status("ell_matmul CUDA kernel", "invalid device function", False)

    monkeypatch.setattr(tbs, "bsr_gram_totals", failing)
    x, y, _ = _problem("sparse")
    with pytest.raises(RuntimeError, match="invalid device function"):
        BlockLeastSquaresEstimator(64, reg=1e-3, device=CPU).fit(
            ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    assert trel.get_recovery_log().summary()["degradations"] == 0


# ------------------------------------------------- the binding's OOM fault


class _StandInLibrary:
    """The binding's error-string entry point, without a card: the texts
    ``cudaGetErrorString`` and ``cublasGetStatusString`` return."""

    TEXTS = {
        _build.CUDA_ERROR_MEMORY_ALLOCATION: "out of memory",
        gemm.CUBLAS_ERR_BASE + 3: "the resource allocation failed",
        gemm.CUBLAS_ERR_BASE + 13: "the GPU program failed to execute",
        -2: "a dimension or leading dimension outside 0..2^31-1",
    }

    def keystone_gemm_error(self, code):
        return self.TEXTS[code].encode()


@pytest.mark.parametrize("code", [_build.CUDA_ERROR_MEMORY_ALLOCATION, gemm.CUBLAS_ERR_BASE + 3])
def test_binding_allocation_failure_classifies_as_oom(code):
    text = _StandInLibrary.TEXTS[code]
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        gemm._raise_on(code, _StandInLibrary(), "gemm")
    assert text in str(info.value)
    assert trel.is_oom(info.value)
    if code != _build.CUDA_ERROR_MEMORY_ALLOCATION:  # the fault: the bare text reads as permanent
        assert trel.classify_error(RuntimeError(f"gemm failed: {text}")) is trel.ErrorClass.PERMANENT


@pytest.mark.parametrize("code", [gemm.CUBLAS_ERR_BASE + 13, -2])
def test_binding_other_failures_stay_permanent(code):
    with pytest.raises(RuntimeError) as info:
        gemm._raise_on(code, _StandInLibrary(), "gemm")
    assert not isinstance(info.value, torch.cuda.OutOfMemoryError)
    assert trel.classify_error(info.value) is trel.ErrorClass.PERMANENT


# --------------------------------------------------------------- executor


def _mnist_pipelines():
    """The small MNIST random-FFT fit in both packages, ending in the
    solver's scores (no ``MaxClassifier``), and each package's test rows."""
    from keystone_tpu.ops.util.labels import ClassLabelIndicators as JIndicators
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators

    cfg_j, cfg_t = jm.MnistRandomFFTConfig(**SMALL_MNIST), tm.MnistRandomFFTConfig(**SMALL_MNIST)
    j_train, j_test = jm.synthetic_mnist(1024, seed=0), jm.synthetic_mnist(256, seed=1)
    t_train = tm.synthetic_mnist(1024, seed=0, device=CPU)
    t_test = tm.synthetic_mnist(256, seed=1, device=CPU)
    j_pipe = jm.build_featurizer(cfg_j).then_label_estimator(
        JEstimator(cfg_j.block_size, num_iter=1, reg=cfg_j.reg),
        j_train.data, JIndicators(10)(j_train.labels),
    )
    t_pipe = tm.build_featurizer(cfg_t, device=CPU).then_label_estimator(
        BlockLeastSquaresEstimator(cfg_t.block_size, num_iter=1, reg=cfg_t.reg, device=CPU),
        t_train.data, ClassLabelIndicators(10)(t_train.labels),
    )
    return (j_pipe, j_test), (t_pipe, t_test)


def test_executor_retries_a_transient_fault_at_a_node_label():
    (jpipe, jtest), (tpipe, ttest) = _mnist_pipelines()
    clean = tpipe.fit().apply_batch(ttest.data)  # no policy, no injector
    texec.PipelineEnv.reset()
    jexec.PipelineEnv.reset()
    jexec.PipelineEnv.get_or_create().retry_policy = jrel.RetryPolicy(max_attempts=3, seed=0, sleep=lambda s: None)
    texec.PipelineEnv.get_or_create().retry_policy = trel.RetryPolicy(max_attempts=3, seed=0, sleep=lambda s: None)
    spec = dict(match=FUSED, kind="transient", calls=(1,))
    with jrel.injected(jrel.FaultSpec(**spec)):
        j_scores = np.asarray(jpipe.fit().apply_batch(jtest.data).data)
    with trel.injected(trel.FaultSpec(**spec)):
        retried = tpipe.fit().apply_batch(ttest.data)
    tsum, jsum = trel.get_recovery_log().summary(), jrel.get_recovery_log().summary()
    assert tsum == jsum
    assert tsum["retries"] == 1 and [e["kind"] for e in tsum["events"]] == ["fault", "retry"]
    assert torch.equal(retried.data, clean.data)
    assert _rel(retried.data.numpy(), j_scores[:256]) <= SOLVE_TOL


def test_executor_without_hooks_returns_the_expression_untouched():
    from keystone_tpu_torch.workflow.operators import Expression

    expression = Expression(lambda: 1)
    assert texec._wrap_reliability(object(), [], expression) is expression


def _counter_values(metric, rules):
    return {rule: metric.value(rule=rule) for rule in rules}


def test_trace_spans_histogram_and_rule_counters_match_jax():
    (jpipe, _), (tpipe, _) = _mnist_pipelines()
    t_runs, j_runs = tnames.metric(tnames.RULE_RUNS), jnames.metric(jnames.RULE_RUNS)
    t_rew, j_rew = tnames.metric(tnames.RULE_REWRITES), jnames.metric(jnames.RULE_REWRITES)
    rules = [
        "SavedStateLoadRule", "EquivalentNodeMergeRule", "NodeOptimizationRule",
        "UnusedBranchRemovalRule", "NodeFusionRule", "StreamingPlanRule",
    ]
    t_hist, j_hist = tnames.metric(tnames.NODE_SECONDS), jnames.metric(jnames.NODE_SECONDS)

    def observations(hist):
        return {dict(key)["op"]: series.count for key, series in hist.series().items()}

    before = [_counter_values(m, rules) for m in (t_runs, j_runs, t_rew, j_rew)]
    t_obs0, j_obs0 = observations(t_hist), observations(j_hist)
    with jtracing.trace() as jtr:
        jpipe.fit()
    with ttracing.trace() as ttr:
        tpipe.fit()
    after = [_counter_values(m, rules) for m in (t_runs, j_runs, t_rew, j_rew)]
    delta = [{r: a[r] - b[r] for r in rules} for a, b in zip(after, before)]
    assert delta[0] == delta[1] and delta[2] == delta[3]
    assert all(delta[0][r] >= 1 for r in rules)

    j_names = Counter(s.name for s in jtr.session.spans() if s.name not in UNPORTED_SPANS)
    t_names = Counter(s.name for s in ttr.session.spans() if s.name not in PORT_SPANS)
    assert t_names == j_names
    port_only = Counter(s.name for s in ttr.session.spans() if s.name in PORT_SPANS)
    assert port_only["plan"] == port_only["plan:verify"] == 1
    assert t_names[f"node:{FUSED}"] == 2 and t_names["solver:fit"] == 1

    labels = Counter(t.label for t in ttr.timings)
    assert sum(t_names[n] for n in t_names if n.startswith("node:")) == sum(labels.values())
    t_obs, j_obs = observations(t_hist), observations(j_hist)
    t_new = {op: n - t_obs0.get(op, 0) for op, n in t_obs.items() if n != t_obs0.get(op, 0)}
    j_new = {op: n - j_obs0.get(op, 0) for op, n in j_obs.items() if n != j_obs0.get(op, 0)}
    assert t_new == j_new == dict(labels)

    fit = ttr.session.find("solver:fit")[0]
    node = {s.span_id: s for s in ttr.session.spans()}[fit.parent_id]
    assert node.name == "node:BlockLeastSquaresEstimator" and fit.attributes["solver"] == "block_ls"
    j_node = [s for s in jtr.session.spans() if s.name == node.name][0]
    assert node.attributes["op"] == j_node.attributes["op"]


def test_nothing_is_traced_outside_trace():
    """With neither ``trace()`` nor a span session the executor records
    nothing; under a bare session both packages open the same node
    spans (``sync_timings=False``: dispatch time, marked ``synced``)."""
    from keystone_tpu.obs import spans as jspans

    (jpipe, _), (tpipe, _) = _mnist_pipelines()
    hist = tnames.metric(tnames.NODE_SECONDS)
    before = hist.count(op="BlockLeastSquaresEstimator")
    tpipe.fit()
    assert hist.count(op="BlockLeastSquaresEstimator") == before
    texec.PipelineEnv.reset()  # the untraced fit's saved state would be reused
    with tspans.tracing_session("bare", sync_timings=False) as session:
        tpipe.fit()
    with jspans.tracing_session("bare", sync_timings=False) as jsession:
        jpipe.fit()
    t_nodes = Counter(s.name for s in session.find("node:"))
    j_nodes = Counter(s.name for s in jsession.find("node:"))
    assert t_nodes == j_nodes and t_nodes[f"node:{FUSED}"] == 2
    assert all(s.attributes["synced"] is False for s in session.find("node:"))
    assert hist.count(op="BlockLeastSquaresEstimator") == before + 1


# ------------------------------------------------------------------- store

FP = {"torch": "test", "backend": "cpu", "device_kind": "virtual"}
J_FP = {"jax": "test", "backend": "cpu", "device_kind": "virtual"}


def _case_round_trip_newest_wins(mod, tmp_path, fp, monkeypatch):
    s = mod.ProfileStore(str(tmp_path / "ps.jsonl"), fingerprint=dict(fp))
    s.record("k", "n2^4", wall_s=1.0)
    s.record("k", "n2^4", wall_s=2.5)
    assert s.lookup("k", "n2^4") == {"wall_s": 2.5, "source": "observed"}
    s2 = mod.ProfileStore(s.path, fingerprint=dict(fp))
    assert s2.lookup("k", "n2^4") == {"wall_s": 2.5, "source": "observed"}
    assert s2._entries[("k", "n2^4", "cpu")]["obs"] == 2
    assert s.lookup("k", "n2^4", backend="cuda") is None and s.misses == 1


def _case_fingerprint_invalidation(mod, tmp_path, fp, monkeypatch):
    s = mod.ProfileStore(str(tmp_path / "ps.jsonl"), fingerprint=dict(fp))
    s.record("k", "n2^4", wall_s=1.0)
    changed = mod.ProfileStore(s.path, fingerprint={**fp, "device_kind": "other-card"})
    assert changed.lookup("k", "n2^4") is None and changed.invalidations == 1
    assert mod.ProfileStore(s.path, fingerprint=dict(fp)).lookup("k", "n2^4") == {
        "wall_s": 1.0, "source": "observed"}


def _case_torn_lines(mod, tmp_path, fp, monkeypatch):
    s = mod.ProfileStore(str(tmp_path / "ps.jsonl"), fingerprint=dict(fp))
    s.record("good", "n2^4", wall_s=1.0)
    with open(s.path, "a") as f:
        f.write('{"k": "torn", "s": "n2^4"')
    s2 = mod.ProfileStore(s.path, fingerprint=dict(fp))
    assert s2.lookup("good", "n2^4") == {"wall_s": 1.0, "source": "observed"}
    assert s2.lookup("torn", "n2^4") is None


def _case_eviction(mod, tmp_path, fp, monkeypatch):
    s = mod.ProfileStore(str(tmp_path / "ps.jsonl"), max_entries=4, fingerprint=dict(fp))
    for i in range(12):
        s.record(f"k{i}", "n2^4", v=i)
    s.compact()
    assert {k for k, _, _ in s.entries()} == {"k8", "k9", "k10", "k11"}
    assert sum(1 for _ in open(s.path)) == 4


def _case_entries_query(mod, tmp_path, fp, monkeypatch):
    s = mod.ProfileStore(str(tmp_path / "ps.jsonl"), fingerprint=dict(fp))
    s.record("blocksparse:threshold", "n2^10|8|float32", threshold=0.1)
    s.record("solver:block_ls:bs4:precrefine", "n2^10|16|float32", wall_s=0.5)
    s.record("solver:block_ls:bs8:precrefine", "n2^11|16|float32", wall_s=0.5)
    assert len(list(s.entries(rows="n2^10"))) == 2
    assert len(list(s.entries(key_prefix="solver:", rows="n2^10"))) == 1


_WRITER = r"""
import sys
sys.path.insert(0, {repo!r})
from {mod}.obs.store import ProfileStore
s = ProfileStore({path!r}, fingerprint={fp!r})
who = sys.argv[1]
for i in range(40):
    s.record("shared", "n2^4", writer=who, i=i)
    s.record(f"{{who}}:{{i}}", "n2^4", v=i)
print("WROTE", who)
"""


def _case_concurrent_writers(mod, tmp_path, fp, monkeypatch):
    path = str(tmp_path / "ps.jsonl")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = _WRITER.format(repo=repo, mod=mod.__name__.split(".")[0], path=path, fp=dict(fp))
    procs = [subprocess.Popen([sys.executable, "-c", script, who], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for who in ("a", "b")]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    with open(path) as f:
        for line in f:
            json.loads(line)
    s = mod.ProfileStore(path, fingerprint=dict(fp))
    keys = {k for k, _, _ in s.entries()}
    assert {f"a:{i}" for i in range(40)} | {f"b:{i}" for i in range(40)} <= keys
    assert s.lookup("shared", "n2^4")["writer"] in ("a", "b")


def _case_off_switch(mod, tmp_path, fp, monkeypatch):
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", "off")
    assert not mod.store_enabled() and mod.get_store() is None
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", str(tmp_path / "b.jsonl"))
    assert mod.get_store().path.endswith("b.jsonl")


def _case_mark_stale(mod, tmp_path, fp, monkeypatch):
    s = mod.ProfileStore(str(tmp_path / "ps.jsonl"), fingerprint=dict(fp))
    s.record("stream:abc:cr512", "n2^12|8|float32", chunk_rows=512)
    assert s.mark_stale("stream:abc:cr512", "n2^12|8|float32") is True
    assert s.mark_stale("stream:abc:cr512", "n2^12|8|float32") is False
    assert s.lookup("stream:abc:cr512", "n2^12|8|float32") is None
    assert s.lookup("stream:abc:cr512", "n2^12|8|float32", include_stale=True)["source"] == "stale:observed"
    assert s.by_source() == {"stale:observed": 1}
    s.record("stream:abc:cr512", "n2^12|8|float32", chunk_rows=512)
    assert s.lookup("stream:abc:cr512", "n2^12|8|float32")["source"] == "observed"


STORE_CASES = {
    "round_trip_newest_wins": _case_round_trip_newest_wins,
    "fingerprint_invalidation": _case_fingerprint_invalidation,
    "torn_lines": _case_torn_lines,
    "eviction": _case_eviction,
    "entries_query": _case_entries_query,
    "concurrent_writers": _case_concurrent_writers,
    "off_switch": _case_off_switch,
    "mark_stale": _case_mark_stale,
}


@pytest.mark.parametrize("package", ["keystone_tpu", "keystone_tpu_torch"])
@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_contract(case, package, tmp_path, monkeypatch):
    """The cases of ``tests/obs/test_store.py``, run on both packages'
    stores (each with its own kind of fingerprint)."""
    mod, fp = (jstore, J_FP) if package == "keystone_tpu" else (tstore, FP)
    STORE_CASES[case](mod, tmp_path, fp, monkeypatch)


def test_store_shape_classes_match_jax():
    for rows, dims, dtype in [(100_000, (768,), "float32"), (131_072, (768,), None), (1, (), None)]:
        assert tstore.shape_class(rows, dims, dtype) == jstore.shape_class(rows, dims, dtype)
    x = np.zeros((100, 16), dtype=np.float64)
    assert tstore.dataset_shape_class(ArrayDataset(x, device=CPU)) == jstore.dataset_shape_class(
        JArrayDataset(x)) == "n2^7|16|float32"
    assert tstore.rows_bucket("n2^17|768|float32") == "n2^17"


def test_port_never_believes_a_jax_written_entry(tmp_path):
    path = str(tmp_path / "shared.jsonl")
    jstore.ProfileStore(path, fingerprint=dict(J_FP)).record("k", "n2^4", wall_s=1.0)
    port = tstore.ProfileStore(path, fingerprint=dict(FP, backend="cpu"))
    assert port.lookup("k", "n2^4") is None and port.invalidations == 1
    assert list(port.entries()) == []
    # The port's own fingerprint names torch, never jax.
    fp = tstore.environment_fingerprint()
    assert set(fp) == {"torch", "backend", "device_kind"} and fp["torch"] == torch.__version__
    assert fp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")


def test_default_store_path(monkeypatch):
    monkeypatch.delenv("KEYSTONE_PROFILE_STORE")
    assert tstore.default_store_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "keystone_tpu_torch", "profile-store.jsonl")


def test_fit_records_a_solver_observation():
    x, y, _ = _problem("in_core")
    BlockLeastSquaresEstimator(64, reg=1e-3, device=CPU).fit(
        ArrayDataset(x, device=CPU), ArrayDataset(y, device=CPU))
    keys = {k for k, _, _ in tstore.get_store().entries(key_prefix="solver:")}
    assert keys == {f"solver:block_ls:bs64:prec{tlinalg.solver_mode()}"}


# ------------------------------------------------ block density, threshold


@pytest.mark.parametrize("shape,density,block", [
    ((64, 96), 0.2, (8, 16)), ((50, 70), 0.3, (8, 16)), ((33, 17), 1.0, (4, 4)),
])
def test_block_density_matches_jax(shape, density, block):
    a = _block_sparse_dense(np.random.RandomState(1), *shape, density)
    assert block_density(a, block) == j_block_density(a, block)


THRESHOLD_ENTRIES = [  # (shape class, threshold, speedup)
    ("n2^10|256|float32", 0.2, 3.0),
    ("n2^10|512|float32", 0.12, 5.0),
    ("n2^12|256|float32", 0.4, 2.0),
]


@pytest.mark.parametrize("rows", ["n2^10", "n2^12", "n2^14", None])
def test_density_threshold_reads_the_same_store_contents(rows, tmp_path, monkeypatch):
    path = str(tmp_path / "thresholds.jsonl")
    monkeypatch.setenv("KEYSTONE_PROFILE_STORE", path)
    for store in (jstore.get_store(), tstore.get_store()):  # each with its own fingerprint
        for shape, threshold, speedup in THRESHOLD_ENTRIES:
            store.record("blocksparse:threshold", shape, threshold=threshold, speedup=speedup, source="tune")
    assert tbs.density_threshold(rows) == jbs.density_threshold(rows)
    want = {"n2^10": 0.12, "n2^12": 0.4, "n2^14": tbs.DEFAULT_DENSITY_THRESHOLD, None: 0.12}
    assert tbs.density_threshold(rows) == want[rows]
    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_THRESHOLD", "0.07")
    assert tbs.density_threshold(rows) == jbs.density_threshold(rows) == 0.07


def test_a_tuned_threshold_flips_the_dispatch(monkeypatch):
    """A stored threshold of 0.0 for the rows bucket sends CSR rows to the
    dense path (``densify``) and keeps a dense host matrix off the
    block-sparse probe; marking the entry stale gives the default back."""
    import scipy.sparse

    from keystone_tpu_torch.data.dataset import ObjectDataset

    monkeypatch.setenv("KEYSTONE_BLOCKSPARSE_BLOCK", f"{BM}x{BN}")
    x = _block_sparse_dense(np.random.RandomState(4), 256, 256, 0.02)  # under the 0.05 default
    est = BlockLeastSquaresEstimator(64, device=CPU)
    rows = ObjectDataset([scipy.sparse.csr_matrix(x[i : i + 1]) for i in range(len(x))])
    dense = ArrayDataset(x, device=CPU)
    assert est._blocksparse_dispatch(rows)[0] == "sparse"
    assert est._blocksparse_dispatch(dense)[0] == "sparse"
    shape = tstore.rows_bucket(tstore.shape_class(x.shape[0])) + "|tuned"
    store = tstore.get_store()
    store.record("blocksparse:threshold", shape, threshold=0.0, speedup=1.0, source="tune")
    assert est._blocksparse_dispatch(rows)[0] == "densify"
    assert est._blocksparse_dispatch(dense) is None
    assert store.mark_stale("blocksparse:threshold", shape)
    assert est._blocksparse_dispatch(rows)[0] == "sparse"


# ------------------------------------------------------- quarantine, schema


def test_load_csv_publishes_the_same_quarantine_event(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,2,3\n4,5,6\n7,x,9\n10,11\n12,13,14\n")
    t = load_csv(str(path), device="cpu")
    j = j_load_csv(str(path))
    assert t.quarantine == j.quarantine and t.quarantine["quarantined"] == 2
    tsum, jsum = trel.get_recovery_log().summary(), jrel.get_recovery_log().summary()
    assert tsum == jsum and tsum["quarantined_records"] == 2
    assert tsum["events"][0]["kind"] == "quarantine" and tsum["events"][0]["label"] == "load_csv"


def test_port_schema_is_a_subset_of_the_jax_schema():
    # Series of the port's own are declared as such, and are the only ones
    # the JAX schema lacks.
    assert set(tnames.SCHEMA) - set(jnames.SCHEMA) == tnames.PORT_ONLY
    for name, spec in tnames.SCHEMA.items():
        if name in tnames.PORT_ONLY:
            continue
        jspec = jnames.SCHEMA[name]
        assert (spec[0], spec[2], spec[3:]) == (jspec[0], jspec[2], jspec[3:]), name
    registry = tnames.register_all(__import__("keystone_tpu_torch.obs.metrics", fromlist=["x"]).MetricsRegistry())
    assert sorted(registry.names()) == sorted(tnames.SCHEMA)


def test_solver_helpers_publish_their_series():
    attempts = tnames.metric(tnames.SOLVER_RUNG_ATTEMPTS)
    iterations = tnames.metric(tnames.SOLVER_ITERATIONS)
    seconds = tnames.metric(tnames.SOLVER_FIT_SECONDS)
    a0, i0, s0 = attempts.value(solver="x"), iterations.value(solver="x"), seconds.count(solver="x")
    with tspans.tracing_session("t") as session:
        with solver_obs.fit_span("x", d=4):
            with solver_obs.rung_span("x", 8, 0):
                solver_obs.count_iteration("x", 3, step=1)
    assert attempts.value(solver="x") == a0 + 1 and iterations.value(solver="x") == i0 + 3
    assert seconds.count(solver="x") == s0 + 1
    assert [s.name for s in session.spans()] == ["solver:iteration", "solver:fit"]
    assert solver_obs.predicted_attrs(object()) == {}
