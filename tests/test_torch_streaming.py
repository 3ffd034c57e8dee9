"""Streaming chunked fits in the port (``keystone_tpu_torch/workflow/streaming.py``),
on the CPU: plan rewrite, boundaries, parity, bounded memory, first
applications, overlap, failure shutdown and the data plumbing under it —
mirrors of the JAX package's ``tests/workflow/test_streaming.py`` and of
``tests/data/test_buckets.py``'s ``BucketedDataset`` tests — and parity
with the JAX package's streamed fits on the same numpy inputs.

Mirrors left out, and why:

- The ``shard`` half of ``test_dtype_preserved_through_pad_and_shard``:
  ``ArrayDataset.shard`` waits for multi-device.
- ``test_max_rows_splits_groups_into_same_shape_buckets`` and
  ``test_edge_padding_replicates_border``: ``data/buckets.py`` (image
  bucketing) is not ported; the ``BucketedDataset`` tests here build the
  buckets directly.

Tolerances: streamed against materialized, and the port against the JAX
package, ≤ 1e-5 relative (the JAX test's bound); the fallback path is
the materialized path itself (≤ 1e-6).
"""

import threading
import time

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import (
    ArrayDataset,
    BucketedDataset,
    ObjectDataset,
    default_ingest_workers,
    transfer_dtype,
)
from keystone_tpu_torch.data.ingest import PrefetchQueue
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.util.misc import CacherOperator
from keystone_tpu_torch.workflow import (
    BatchTransformer,
    LabelEstimator,
    Pipeline,
    streaming_disabled,
)
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.streaming import (
    ChunkStream,
    StreamingFitOperator,
    last_stream_report,
    stream_pipelined,
)

CHUNK = 64
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    # Both packages read this knob.
    monkeypatch.setenv("KEYSTONE_STREAM_CHUNK_ROWS", str(CHUNK))
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


class Scale(BatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply_arrays(self, x):
        return x * self.c


class Shift(BatchTransformer):
    def __init__(self, c):
        self.c = float(c)

    def apply_arrays(self, x):
        return x + self.c


def _cpu(a, **kw):
    return ArrayDataset(a, device=CPU, **kw)


def _problem(n=8 * CHUNK, d=32, k=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    w = rng.normal(size=(d, k)).astype(np.float32)
    y = (x.astype(np.float32) @ w + 0.01 * rng.normal(size=(n, k))).astype(np.float32)
    return x, y


def _block(block=16, num_iter=2, reg=1e-3):
    return BlockLeastSquaresEstimator(block, num_iter=num_iter, reg=reg, device=CPU)


def _chain_pipeline(x, y, est=None):
    feat = Scale(2.0).to_pipeline().then(Shift(0.5))
    return feat.then_label_estimator(est or _block(), _cpu(x), _cpu(y))


def _fit_predict(pipe, x):
    handle = pipe.apply(_cpu(x))
    return handle, handle.get().data[: x.shape[0]].numpy()


def _stream_ops(graph):
    return [op for op in graph.operators.values() if isinstance(op, StreamingFitOperator)]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------- plan rewrite


def test_plan_rewrites_eligible_chain():
    x, y = _problem()
    handle = _chain_pipeline(x, y).apply(_cpu(x))
    ops = _stream_ops(handle._executor.graph)
    assert len(ops) == 1
    # The fit-side chain was absorbed (flattened out of the fused node).
    assert [type(m).__name__ for m in ops[0].members] == ["Scale", "Shift"]
    assert ops[0].label == "StreamFit[BlockLeastSquaresEstimator+2ops]"
    assert handle.get().data.shape[1] == y.shape[1]


def test_no_rewrite_without_fit_stream_support():
    class ToyEstimator(LabelEstimator):
        def fit(self, data, labels):
            return Shift(0.0)

    x, y = _problem(n=4 * CHUNK)
    handle = _chain_pipeline(x, y, est=ToyEstimator()).apply(_cpu(x))
    assert not _stream_ops(handle._executor.graph)


def test_no_rewrite_below_row_floor():
    x, y = _problem(n=CHUNK)  # one chunk: the materialized path wins
    handle = _chain_pipeline(x, y).apply(_cpu(x))
    assert not _stream_ops(handle._executor.graph)


def test_no_rewrite_when_disabled():
    x, y = _problem()
    with streaming_disabled():
        handle = _chain_pipeline(x, y).apply(_cpu(x))
        assert not _stream_ops(handle._executor.graph)


# -------------------------------------------------------------------- parity


def test_parity_synthetic_chain():
    x, y = _problem()
    _, streamed = _fit_predict(_chain_pipeline(x, y), x)
    assert last_stream_report() is not None and last_stream_report().chunks == 8
    PipelineEnv.reset()
    with streaming_disabled():
        _, materialized = _fit_predict(_chain_pipeline(x, y), x)
    assert _rel(streamed, materialized) <= 1e-5


def test_parity_mnist_fft_features():
    """Streamed against materialized on MNIST-FFT featurized data at the
    λ floor (reg=0), overdetermined (n > d)."""
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_featurizer

    n, pixels = 8 * CHUNK, 64
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, pixels)).astype(np.float32)
    feats = build_featurizer(MnistRandomFFTConfig(num_ffts=2), image_size=pixels, device=CPU)
    feats = feats(_cpu(x)).get().data[:n].numpy()
    assert feats.shape[1] < n
    y = -np.ones((n, 10), np.float32)
    y[np.arange(n), rng.integers(0, 10, n)] = 1.0

    def build():
        return _block(64, num_iter=1, reg=0.0).with_data(_cpu(feats), _cpu(y))

    handle, streamed = _fit_predict(build(), feats)
    assert _stream_ops(handle._executor.graph), "direct dataset→fit did not stream"
    PipelineEnv.reset()
    with streaming_disabled():
        _, materialized = _fit_predict(build(), feats)
    assert _rel(streamed, materialized) <= 1e-5


def test_parity_cacher_boundary():
    """A Cacher between featurize stages cuts the streamed chain: the
    stream starts from the cached output."""
    x, y = _problem()

    def build():
        graph_pipe = Scale(3.0).to_pipeline()
        graph = graph_pipe.graph
        graph, cache_node = graph.add_node(
            CacherOperator("t"), [graph.get_sink_dependency(graph_pipe.sink)]
        )
        graph = graph.set_sink_dependency(graph_pipe.sink, cache_node)
        feat = Pipeline(graph, graph_pipe.source, graph_pipe.sink).then(Shift(-0.25))
        return feat.then_label_estimator(_block(num_iter=1), _cpu(x), _cpu(y))

    handle, streamed = _fit_predict(build(), x)
    ops = _stream_ops(handle._executor.graph)
    assert len(ops) == 1
    assert [type(m).__name__ for m in ops[0].members] == ["Shift"]
    assert any(isinstance(op, CacherOperator) for op in handle._executor.graph.operators.values())
    PipelineEnv.reset()
    with streaming_disabled():
        _, materialized = _fit_predict(build(), x)
    assert _rel(streamed, materialized) <= 1e-5


def test_fit_stream_linear_map_exact_parity():
    x, y = _problem(d=24, k=3)
    est = LinearMapEstimator(reg=1e-2, device=CPU)
    streamed = est.fit_stream(ChunkStream(_cpu(x), _cpu(y), (), chunk_rows=CHUNK, device=CPU))
    materialized = est.fit(_cpu(x), _cpu(y))
    a = streamed.apply_arrays(torch.from_numpy(x))
    b = materialized.apply_arrays(torch.from_numpy(x))
    assert _rel(a, b) <= 1e-5


# ---------------------------------------------------- memory/compile/overlap


def test_bounded_host_memory():
    """Dataset 10× chunk; host chunk buffers stay under 2× one chunk
    (queue depth 1 + one in hand)."""
    x, y = _problem(n=10 * CHUNK, d=64, k=4)
    _fit_predict(_chain_pipeline(x, y), x)
    rep = last_stream_report()
    assert rep is not None and rep.chunks == 10
    chunk_bytes = CHUNK * 64 * 4 + CHUNK * 4 * 4 + CHUNK * 4  # x + y + mask
    assert rep.host_buffer_peak_bytes <= 2 * chunk_bytes
    assert rep.host_buffer_peak_bytes < x.nbytes / 2


def test_one_compile_per_chunk_shape_and_overlap():
    x, y = _problem()
    pipe = _chain_pipeline(x, y)
    _fit_predict(pipe, x)
    rep = last_stream_report()
    assert rep.compiles_first_chunk == 1  # one chunk shape
    assert rep.compiles_steady_state == 0  # the tail chunk is padded to it
    assert rep.overlap_ok()
    assert rep.device_overlap_ok is None  # no copy engine on the CPU
    PipelineEnv.reset()
    _fit_predict(pipe, x)  # re-fit, same member instances: nothing new
    rep2 = last_stream_report()
    assert rep2 is not rep
    assert (rep2.compiles_first_chunk, rep2.compiles_steady_state) == (1, 0)


def test_uint8_chunks_cross_narrow_and_cast_on_device():
    rng = np.random.default_rng(5)
    n, h = 8 * CHUNK, 16
    imgs = rng.integers(0, 256, size=(n, h), dtype=np.uint8)
    w = rng.normal(size=(h, 3)).astype(np.float32)
    y = (imgs.astype(np.float32) @ w).astype(np.float32)
    _fit_predict(_chain_pipeline(imgs, y), imgs.astype(np.float32))
    rep = last_stream_report()
    per_chunk = CHUNK * h * 1 + CHUNK * 3 * 4 + CHUNK * 4  # uint8 x + y + mask
    assert rep.bytes_transferred == 8 * per_chunk


class TensorScale(BatchTransformer):
    """Holds its factor as a tensor, so a host ObjectDataset batch-applied
    to it (the materialized path) is stacked onto the tensor's device."""

    def __init__(self, c):
        self.c = torch.tensor(float(c), device=CPU)

    def apply_arrays(self, x):
        return x * self.c


def test_object_dataset_streams_via_worker_stacking():
    x, y = _problem(n=6 * CHUNK, d=16, k=2)
    est = _block(8, num_iter=1)
    scale = TensorScale(1.5)
    pipe = scale.to_pipeline().then_label_estimator(
        est, ObjectDataset([x[i] for i in range(len(x))]), _cpu(y)
    )
    handle, streamed = _fit_predict(pipe, x)
    assert _stream_ops(handle._executor.graph)
    assert last_stream_report().chunks == 6
    PipelineEnv.reset()
    with streaming_disabled():
        pipe2 = scale.to_pipeline().then_label_estimator(
            est, ObjectDataset([x[i] for i in range(len(x))]), _cpu(y)
        )
        _, materialized = _fit_predict(pipe2, x)
    assert _rel(streamed, materialized) <= 1e-5


def test_runtime_fallback_on_unchunkable_dataset():
    """A planned stream whose data turns out unchunkable at run time (a
    BucketedDataset) takes the materialized path and records why."""
    from keystone_tpu_torch.obs.spans import tracing_session

    x, y = _problem(n=4 * CHUNK, d=16, k=2)
    buckets = BucketedDataset([_cpu(x[i : i + CHUNK]) for i in range(0, len(x), CHUNK)])
    op = StreamingFitOperator(_block(8, num_iter=1), (Scale(2.0),))
    with tracing_session() as session:
        model = op.fit_datasets([buckets, _cpu(y)])
    (span,) = session.find("stream:fit")
    assert "not chunkable" in span.attributes["fallback"]
    ref = _block(8, num_iter=1).fit(Scale(2.0).apply_batch(_cpu(x)), _cpu(y))
    a = model.apply_arrays(torch.from_numpy(x))
    b = ref.apply_arrays(torch.from_numpy(x))
    assert _rel(a, b) <= 1e-6


def test_fallback_only_for_the_stream_reasons():
    """A stream falls back for a non-matrix chain or missing labels; any
    other exception from the chain propagates."""
    x, y = _problem(n=4 * CHUNK, d=8, k=2)

    class Pair(BatchTransformer):
        def apply_arrays(self, a):
            return (a, a)

    class Broken(BatchTransformer):
        def apply_arrays(self, a):
            raise ValueError("broken member")

    est = _block(8, num_iter=1)
    for members, labels in (((Pair(),), _cpu(y)), ((), None)):
        with pytest.raises(Exception) as info:
            est.fit_stream(ChunkStream(_cpu(x), labels, members, chunk_rows=CHUNK, device=CPU))
        assert type(info.value).__name__ == "StreamingFallback"
    with pytest.raises(ValueError, match="broken member"):
        est.fit_stream(ChunkStream(_cpu(x), _cpu(y), (Broken(),), chunk_rows=CHUNK, device=CPU))


# ------------------------------------------------------------------ failure


def _prefetch_threads():
    return [t for t in threading.enumerate() if "prefetch" in t.name and t.is_alive()]


def test_prefetch_shutdown_on_midstream_failure():
    from keystone_tpu_torch.reliability.faultinject import KNOWN_PROBE_SITES, FaultSpec, injected

    assert "streaming.chunk" in KNOWN_PROBE_SITES
    x, y = _problem()
    pipe = _chain_pipeline(x, y)
    with injected(FaultSpec(match="streaming.chunk", kind="transient", calls=(3,))):
        with pytest.raises(ConnectionError):
            pipe.apply(_cpu(x)).get()
    for _ in range(50):
        if not _prefetch_threads():
            break
        time.sleep(0.05)
    assert not _prefetch_threads(), "leaked prefetch workers"


# ------------------------------------------------------------- data plumbing


def test_iter_chunks_array_and_object():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    chunks = list(_cpu(x).iter_chunks(4))
    assert [n for _, n in chunks] == [4, 4, 2]
    assert all(isinstance(c, np.ndarray) for c, _ in chunks)  # host windows
    assert np.array_equal(np.concatenate([c for c, _ in chunks]), x)
    chunks_o = list(ObjectDataset([x[i] for i in range(10)]).iter_chunks(4))
    assert [n for _, n in chunks_o] == [4, 4, 2]
    assert np.array_equal(np.concatenate([c for c, _ in chunks_o]), x)


def test_dtype_preserved_through_pad():
    ds = _cpu(np.zeros((10, 4, 4, 3), np.uint8))
    padded = ds.padded_to(8)
    assert padded.physical_rows == 16 and padded.num_examples == 10
    assert padded.data.dtype == torch.uint8
    assert ds.padded_to(5) is ds
    assert transfer_dtype(np.float64) == np.float32
    assert transfer_dtype(np.int64) == np.int32
    assert transfer_dtype(np.uint8) == np.uint8


def test_ingest_workers_env(monkeypatch):
    monkeypatch.setenv("KEYSTONE_INGEST_WORKERS", "3")
    assert default_ingest_workers() == 3
    monkeypatch.delenv("KEYSTONE_INGEST_WORKERS")
    assert default_ingest_workers() >= 2


def test_object_dataset_parallel_map_keeps_order():
    items = list(range(200))
    assert ObjectDataset(items).map(lambda v: v * v).collect() == [v * v for v in items]
    assert ObjectDataset(items[:5]).map(lambda v: -v, parallel=True).collect() == [0, -1, -2, -3, -4]


def _drain(queue, timeout=10.0):
    """Consume ``queue`` on a helper thread, bounded by ``timeout``:
    (items consumed, the exception that ended it or None)."""
    got, error = [], []

    def consume():
        try:
            for v in queue:
                got.append(v)
        except Exception as e:  # handed to the test thread
            error.append(e)

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the prefetch queue did not finish in time"
    return got, (error[0] if error else None)


def test_prefetch_queue_order_errors_and_close():
    q = PrefetchQueue(iter(range(20)), lambda i: i * i, depth=3, workers=3)
    got, error = _drain(q)
    assert error is None and got == [i * i for i in range(20)]
    q.close()

    def boom(i):
        if i == 5:
            raise ValueError("bad item")
        return i

    q2 = PrefetchQueue(iter(range(10)), boom, depth=2, workers=2)
    got, error = _drain(q2)
    assert isinstance(error, ValueError) and "bad item" in str(error)
    assert got == [0, 1, 2, 3, 4]  # order preserved up to the failure
    q2.close()
    q2.close()  # idempotent
    assert not _prefetch_threads()


def test_prefetch_queue_order_under_contention():
    """More workers than cores and a short switch interval: every item
    arrives once, in source order, and the live-byte bound holds."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        q = PrefetchQueue(iter(range(300)), lambda i: np.full(8, i), depth=4, workers=16, size_of=lambda a: a.nbytes)
        got, error = _drain(q, timeout=30)
        q.close()
    finally:
        sys.setswitchinterval(interval)
    assert error is None and [int(a[0]) for a in got] == list(range(300))
    assert q.peak_live_bytes <= 4 * 8 * 8
    assert not _prefetch_threads()


def test_stream_pipelined_stages_ahead():
    log = []
    n = stream_pipelined(
        range(4),
        stage=lambda i: log.append(("stage", i)) or i,
        compute=lambda s, i: log.append(("compute", i)) or i,
        consume=lambda r, i: log.append(("consume", i)),
        prefetch=2,
    )
    assert n == 4
    # Item i+1 is staged before item i is computed; consume trails by one.
    assert log.index(("stage", 1)) < log.index(("compute", 0))
    assert log.index(("stage", 3)) < log.index(("compute", 2))
    assert log.index(("compute", 1)) < log.index(("consume", 0))
    assert [e for e in log if e[0] == "consume"] == [("consume", i) for i in range(4)]


def test_bucketed_dataset_protocol():
    rng = np.random.default_rng(0)
    bd = BucketedDataset([
        _cpu(rng.random((2, 20, 20, 3)).astype(np.float32)),
        _cpu(rng.random((1, 50, 40, 3)).astype(np.float32)),
    ])
    assert len(bd) == 3
    assert bd.num_shards == 2
    assert bd.per_shard_counts() == [2, 1]
    assert len(bd.collect()) == 3


def test_bucketed_map_batched_and_concat():
    rng = np.random.default_rng(0)
    images = [rng.random((2, 20, 20, 3)).astype(np.float32), rng.random((1, 50, 40, 3)).astype(np.float32)]
    bd = BucketedDataset([_cpu(a) for a in images])
    summed = bd.map_datasets(lambda b: ArrayDataset(b.data.sum(dim=(1, 2)), b.num_examples))
    dense = summed.concat()
    assert tuple(dense.data.shape) == (3, 3)
    direct = np.concatenate([a.sum(axis=(1, 2)) for a in images])
    np.testing.assert_allclose(dense.data.numpy(), direct, rtol=1e-6)
    # A batched transformer maps per bucket.
    scaled = Scale(2.0).apply_batch(bd)
    assert isinstance(scaled, BucketedDataset)
    assert torch.equal(scaled.buckets[1].data, 2.0 * bd.buckets[1].data)


def test_empty_bucket_list_rejected():
    with pytest.raises(ValueError):
        BucketedDataset([])


# ------------------------------------------------------- parity with the JAX package


def _jax_chain_pipeline(x, y):
    from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.ops.learning.block import BlockLeastSquaresEstimator as JBlock
    from keystone_tpu.workflow import BatchTransformer as JBatchTransformer

    class JScale(JBatchTransformer):
        def apply_arrays(self, a):
            return a * 2.0

    class JShift(JBatchTransformer):
        def apply_arrays(self, a):
            return a + 0.5

    feat = JScale().to_pipeline().then(JShift())
    return feat.then_label_estimator(
        JBlock(16, num_iter=2, reg=1e-3), JArrayDataset(x), JArrayDataset(y)
    ), JArrayDataset


def test_streamed_fit_matches_jax_streamed_fit():
    """The synthetic Scale → Shift → BlockLeastSquaresEstimator chain on
    the same numpy inputs: the JAX package's streamed fit and the port's
    agree to 1e-5, and so do the port's streamed and materialized fits."""
    from keystone_tpu.workflow.executor import PipelineEnv as JPipelineEnv
    from keystone_tpu.workflow.streaming import last_stream_report as j_report

    x, y = _problem(seed=11)
    JPipelineEnv.reset()
    try:
        jpipe, JArrayDataset = _jax_chain_pipeline(x, y)
        j_pred = np.asarray(jpipe.apply(JArrayDataset(x)).get().data)[: len(x)]
        assert j_report().chunks == 8
    finally:
        JPipelineEnv.reset()
    _, t_stream = _fit_predict(_chain_pipeline(x, y), x)
    assert last_stream_report().chunks == 8
    PipelineEnv.reset()
    with streaming_disabled():
        _, t_mat = _fit_predict(_chain_pipeline(x, y), x)
    assert _rel(t_stream, j_pred) <= 1e-5
    assert _rel(t_stream, t_mat) <= 1e-5


def test_linear_map_fits_match_jax():
    from keystone_tpu.data.dataset import ArrayDataset as JArrayDataset
    from keystone_tpu.ops.learning.linear import LinearMapEstimator as JLinear
    from keystone_tpu.workflow.streaming import ChunkStream as JChunkStream

    x, y = _problem(d=24, k=3, seed=4)
    j_fit = JLinear(reg=1e-2).fit(JArrayDataset(x), JArrayDataset(y))
    j_stream = JLinear(reg=1e-2).fit_stream(
        JChunkStream(JArrayDataset(x), JArrayDataset(y), (), chunk_rows=CHUNK)
    )
    est = LinearMapEstimator(reg=1e-2, device=CPU)
    t_fit = est.fit(_cpu(x), _cpu(y))
    t_stream = est.fit_stream(ChunkStream(_cpu(x), _cpu(y), (), chunk_rows=CHUNK, device=CPU))
    want = np.asarray(j_fit.apply_arrays(x))
    assert _rel(np.asarray(j_stream.apply_arrays(x)), want) <= 1e-5
    for model in (t_fit, t_stream):
        assert _rel(model.apply_arrays(torch.from_numpy(x)), want) <= 1e-5
