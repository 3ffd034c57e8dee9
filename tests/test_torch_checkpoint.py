"""The checkpoint store in the port (``keystone_tpu_torch/reliability/checkpoint.py``
and the executor's checkpoint layer) on the CPU: digest stability and
sensitivity, the tensor token, torn-file tolerance, in-process resume,
and the killed-then-resumed subprocess run — mirrors of
``tests/reliability/test_checkpoint.py``.

Digests are the port's own: they need not equal the JAX package's (the
class modules differ), but they must be equal across two port
processes, equal for a tensor and its numpy twin, and blind to the
device an operator names.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.learning.linear import LinearMapper
from keystone_tpu_torch.reliability import (
    CheckpointStore,
    enable_checkpointing,
    get_recovery_log,
    prefix_digest,
)
from keystone_tpu_torch.reliability import checkpoint as cp
from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.pipeline import Estimator, Transformer
from keystone_tpu_torch.workflow.prefix import Prefix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Scale(Transformer):
    def __init__(self, s):
        self.s = s

    def apply(self, datum):
        return datum * self.s

    def apply_batch(self, ds):
        return ArrayDataset(ds.data * self.s, ds.num_examples)


class _CountingEstimator(Estimator):
    fits = []

    def __init__(self, tag, device=None):
        self.tag = tag
        self.device = device

    def fit(self, data):
        _CountingEstimator.fits.append(self.tag)
        return _Scale(float(data.data.mean()))


class _Holder:
    """An operator-like object holding a tensor attribute."""

    def __init__(self, weights, device=None):
        self.weights = weights
        self.device = device


@pytest.fixture(autouse=True)
def _clear():
    _CountingEstimator.fits = []
    PipelineEnv.reset()
    yield
    PipelineEnv.reset()


def _data(arr):
    return ArrayDataset(np.asarray(arr, np.float32), device="cpu")


def _prefix_for(est, arr):
    return Prefix((est, ((DatasetOperator(_data(arr)), ()),)))


# ------------------------------------------------------------------ digests


def test_prefix_digest_stable_across_fresh_objects():
    a = prefix_digest(_prefix_for(_CountingEstimator("A"), np.arange(4.0)))
    b = prefix_digest(_prefix_for(_CountingEstimator("A"), np.arange(4.0)))
    assert a == b


def test_prefix_digest_stable_for_set_attributes():
    class WithSet(_CountingEstimator):
        def __init__(self, items):
            super().__init__("S")
            self.items = set(items)

    a = prefix_digest(_prefix_for(WithSet(["x", "y", "z"]), np.arange(4.0)))
    b = prefix_digest(_prefix_for(WithSet(["z", "y", "x"]), np.arange(4.0)))
    assert a == b


def test_prefix_digest_sensitive_to_config_and_data():
    base = prefix_digest(_prefix_for(_CountingEstimator("A"), np.arange(4.0)))
    assert base != prefix_digest(_prefix_for(_CountingEstimator("B"), np.arange(4.0)))
    assert base != prefix_digest(_prefix_for(_CountingEstimator("A"), np.arange(4.0) + 1))


def test_prefix_digest_ignores_the_device_an_operator_names():
    base = prefix_digest(_prefix_for(_CountingEstimator("A"), np.arange(4.0)))
    assert base == prefix_digest(_prefix_for(_CountingEstimator("A", device="cpu"), np.arange(4.0)))
    assert base == prefix_digest(_prefix_for(_CountingEstimator("A", device=torch.device("cpu")), np.arange(4.0)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_])
def test_tensor_token_equals_its_numpy_twins(dtype):
    arr = (np.random.default_rng(0).normal(size=(5, 3)) * 4).astype(dtype)
    assert cp._value_token(torch.from_numpy(arr)) == cp._value_token(arr)
    # Non-contiguous views read their values, not their storage.
    assert cp._value_token(torch.from_numpy(arr).t()) == cp._value_token(arr.T)


def test_bfloat16_tokens_by_its_bits_under_its_own_name():
    t = torch.randn(4, 4).to(torch.bfloat16)
    token = cp._value_token(t)
    assert token[1] == "bfloat16"
    assert token == cp._value_token(t.clone())
    assert token != cp._value_token(t.to(torch.float32))
    assert token != cp._value_token(t + 1)


def test_operators_differing_only_in_tensor_content_digest_differently():
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    same = cp._op_token(_Holder(w.clone()))
    assert cp._op_token(_Holder(w)) == same
    assert cp._op_token(_Holder(w + 1)) != same
    assert cp._op_token(_Holder(w, device="cpu")) == same


def test_a_tensor_inside_an_object_attribute_reaches_the_tensor_token():
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    holder = _Holder(LinearMapper(w))
    assert cp._op_token(holder) == cp._op_token(_Holder(LinearMapper(w.clone())))
    assert cp._op_token(holder) != cp._op_token(_Holder(LinearMapper(w * 2)))
    # The mapper's token reads its tensor's content token.
    assert repr(cp._value_token(w)) in repr(cp._op_token(holder))


_DIGEST_SCRIPT = """
import numpy as np
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.reliability import prefix_digest
from keystone_tpu_torch.workflow.operators import DatasetOperator
from keystone_tpu_torch.workflow.prefix import Prefix
arr = np.arange(24, dtype=np.float32).reshape(8, 3)
op = DatasetOperator(ArrayDataset(arr, device="cpu"))
print(prefix_digest(Prefix((LinearMapEstimator(reg=0.5, device="cpu"), ((op, ()),)))))
"""


def test_prefix_digest_is_equal_across_processes():
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator

    arr = np.arange(24, dtype=np.float32).reshape(8, 3)
    here = prefix_digest(_prefix_for(LinearMapEstimator(reg=0.5, device="cpu"), arr))
    out = subprocess.run(
        [sys.executable, "-c", _DIGEST_SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONHASHSEED": "123"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == here


# -------------------------------------------------------------------- store


def test_store_round_trip_and_torn_file(tmp_path):
    store = CheckpointStore(str(tmp_path), device="cpu")
    prefix = _prefix_for(_CountingEstimator("A"), np.arange(4.0))
    model = LinearMapper(torch.ones(3, 2))
    assert store.save(prefix, model)
    back = store.lookup(prefix)
    assert isinstance(back, LinearMapper) and torch.equal(back.weights, model.weights)
    assert back.weights.device.type == "cpu"
    assert store.stats() == {"hits": 1, "misses": 0, "writes": 1}
    assert store.last_write_bytes > 0
    # A torn entry is a miss, never an exception.
    entry = os.path.join(str(tmp_path), prefix_digest(prefix) + ".pkl")
    with open(entry, "r+b") as f:
        f.truncate(7)
    assert store.lookup(prefix) is cp._MISS
    # A writer killed mid-write leaves only a *.tmp, which lookups ignore.
    with open(os.path.join(str(tmp_path), "abc.tmp"), "wb") as f:
        f.write(b"partial")
    assert store.lookup(None, digest="abc") is cp._MISS
    assert store.delete(prefix_digest(prefix)) and not store.delete("nope")


def test_unpicklable_fit_is_skipped_not_fatal(tmp_path):
    store = CheckpointStore(str(tmp_path), device="cpu")
    prefix = _prefix_for(_CountingEstimator("A"), np.arange(4.0))
    assert store.save(prefix, lambda x: x) is False  # lambdas don't pickle
    assert os.listdir(str(tmp_path)) == []


def test_store_without_a_card_or_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointStore(str(tmp_path))


# ------------------------------------------------------------------- resume


def test_in_process_resume_skips_refit(tmp_path):
    ck = str(tmp_path / "ck")
    enable_checkpointing(ck, device="cpu")
    data = _data(np.arange(8.0).reshape(8, 1))
    out1 = _CountingEstimator("A").with_data(data).apply(data).get()
    assert _CountingEstimator.fits == ["A"]
    PipelineEnv.reset()  # "new process": fresh env, fresh objects, same content
    enable_checkpointing(ck, device="cpu")
    data2 = _data(np.arange(8.0).reshape(8, 1))
    out2 = _CountingEstimator("A").with_data(data2).apply(data2).get()
    assert _CountingEstimator.fits == ["A"]  # NOT refit
    assert get_recovery_log().summary()["checkpoint_hits"] == 1
    np.testing.assert_allclose(out1.data.numpy(), out2.data.numpy())


def test_changed_estimator_config_refits(tmp_path):
    ck = str(tmp_path / "ck")
    enable_checkpointing(ck, device="cpu")
    data = _data(np.arange(8.0).reshape(8, 1))
    _CountingEstimator("A").with_data(data).apply(data).get()
    PipelineEnv.reset()
    enable_checkpointing(ck, device="cpu")
    _CountingEstimator("B").with_data(data).apply(data).get()
    assert _CountingEstimator.fits == ["A", "B"]


_RESUME_SCRIPT = """
import os, sys
import numpy as np
from keystone_tpu_torch.data.dataset import ArrayDataset
from keystone_tpu_torch.workflow.pipeline import Estimator, Transformer
from keystone_tpu_torch import reliability as R

ckdir, countfile, mode = sys.argv[1], sys.argv[2], sys.argv[3]


class Scale(Transformer):
    def __init__(self, s):
        self.s = s

    def apply(self, d):
        return d * self.s

    def apply_batch(self, ds):
        return ArrayDataset(ds.data * self.s, ds.num_examples)


class CountingEst(Estimator):
    def __init__(self, tag):
        self.tag = tag

    def fit(self, data):
        with open(countfile, "a") as f:
            f.write(self.tag + "\\n")
        return Scale(float(data.data.mean()) + 1.0)


R.enable_checkpointing(ckdir, device="cpu")
data = ArrayDataset(np.arange(8.0, dtype=np.float32).reshape(8, 1), device="cpu")
out_a = CountingEst("A").with_data(data).apply(data).get()
if mode == "kill":
    os._exit(137)  # preemption AFTER A's fit, before the run ends
out_a2 = CountingEst("A").with_data(data).apply(data).get()
out_b = CountingEst("B").with_data(data).apply(data).get()
hits = R.get_recovery_log().summary()["checkpoint_hits"]
print("RESUME_OK hits=%d" % hits)
assert hits >= 1, hits
"""


def test_killed_then_resumed_run_reuses_fitted_prefixes(tmp_path):
    ck = str(tmp_path / "ck")
    countfile = str(tmp_path / "fits.txt")
    script = str(tmp_path / "resume_script.py")
    with open(script, "w") as f:
        f.write(_RESUME_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run1 = subprocess.run([sys.executable, script, ck, countfile, "kill"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert run1.returncode == 137, run1.stderr[-2000:]
    assert open(countfile).read().splitlines() == ["A"]
    run2 = subprocess.run([sys.executable, script, ck, countfile, "resume"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert run2.returncode == 0, (run2.stdout + run2.stderr)[-2000:]
    assert "RESUME_OK" in run2.stdout
    assert sorted(open(countfile).read().splitlines()) == ["A", "B"]


def test_token_memo_hashes_shared_values_once(monkeypatch):
    arr = np.arange(64, dtype=np.float32)
    cold = cp._value_token(arr)
    calls = {"n": 0}
    real_sha1 = cp.hashlib.sha1

    def counting_sha1(*a, **kw):
        calls["n"] += 1
        return real_sha1(*a, **kw)

    monkeypatch.setattr(cp.hashlib, "sha1", counting_sha1)
    with cp.token_memo():
        tokens = [cp._value_token(arr) for _ in range(5)]
    assert calls["n"] == 1
    assert all(t == cold for t in tokens)
    assert cp._value_token(arr) == cold
    assert calls["n"] == 2
